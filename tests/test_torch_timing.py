"""The kernel timer (plutus_halo2_tpu_torch/utils/profiling.py: kernel_us,
window_us, device_ms) on the CPU: it sums only the named kernels' device
durations between a window's markers, refuses a window that lost one, and
raises, never falling back to the host clock, when the kernels are absent
or there is no card."""

import pytest

torch = pytest.importorskip("torch")

from plutus_halo2_tpu_torch.utils import profiling  # noqa: E402

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "void pairing_kernel<32>(long const*)", "ts": 0, "dur": 40.0},
    {"ph": "X", "cat": "kernel", "name": "void pairing_kernel<32>(long const*)", "ts": 50, "dur": 42.0},
    {"ph": "X", "cat": "kernel", "name": "Kernel2", "ts": 100, "dur": 3.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 110, "dur": 7.0},
    {"ph": "X", "cat": "cpu_op", "name": "pairing_kernel launch", "ts": 0, "dur": 500.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1, "dur": 5.0},
    {"ph": "i", "cat": "kernel", "name": "pairing_kernel", "ts": 120},
]


def test_kernel_us_sums_only_the_named_kernels():
    assert profiling.kernel_us(EVENTS, ["pairing_kernel"]) == (82.0, 2)
    assert profiling.kernel_us({"traceEvents": EVENTS}, ["Kernel2", "pairing"]) == (85.0, 3)
    # every device kernel of the window (a library call's whole work), never
    # the host's ops, the runtime's launch calls or a copy
    assert profiling.kernel_us(EVENTS) == (85.0, 3)


def test_kernel_us_reads_a_gzipped_trace(tmp_path):
    import gzip
    import json

    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": EVENTS}, f)
    assert profiling.kernel_us(str(path), ["pairing_kernel"]) == (82.0, 2)


@pytest.mark.parametrize("names", [["msm_kernel"], None])
def test_kernel_us_raises_when_the_kernels_took_no_device_time(names):
    host_only = [e for e in EVENTS if e["cat"] != "kernel"]
    with pytest.raises(ValueError):
        profiling.kernel_us(EVENTS if names else host_only, names)
    with pytest.raises(ValueError):
        profiling.kernel_us([{"ph": "X", "cat": "kernel", "name": "msm_kernel", "ts": 0, "dur": 0.0}], names)


MARKS = [{"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)", "ts": t, "dur": 1.0} for t in (-5, 130)]


FILLER = {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel", "ts": -9, "dur": 2.0}


def test_window_us_needs_both_edge_markers():
    # two calls, each one pairing kernel: neither the markers nor the
    # fillers before the start marker are counted
    assert profiling.window_us(MARKS + EVENTS + [FILLER], ["pairing_kernel"], 2) == 82.0
    assert profiling.window_us(MARKS + EVENTS + [FILLER], None, 2) == 85.0
    # a marker lost at an edge, or a named kernel lost of the calls' own
    assert profiling.window_us(MARKS[:1] + EVENTS, ["pairing_kernel"], 2) is None
    assert profiling.window_us(MARKS[1:] + EVENTS, None, 2) is None
    assert profiling.window_us(MARKS + EVENTS[1:], ["pairing_kernel"], 2) is None
    with pytest.raises(ValueError):  # both markers there, the named kernel absent
        profiling.window_us(MARKS + EVENTS, ["msm_kernel"], 2)


def test_device_ms_raises_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_ms(lambda: calls.append(1), ["pairing_kernel"])
    assert calls == []  # nothing ran, nothing was timed on the host
