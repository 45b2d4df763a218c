"""The kernel timer (plutus_halo2_tpu_torch/utils/profiling.py: kernel_us,
window_us, device_ms) on the CPU: it sums only the named kernels' device
durations between a window's markers, refuses a window that lost one or
lost records between them (a count other than calls x the per-call count,
for named kernels and for all of them), and device_ms refuses such a
window, and one whose kernels outlast the CUDA events around the calls,
and tries again with more fillers; it raises, never falling back to the
host clock, when the kernels are absent or there is no card."""

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


def _calls(n, per_call=("void pairing_kernel<32>(long const*)", "Kernel2"), t0=0.0):
    """n calls' kernels, each call launching `per_call` in turn, 10 us apart."""
    out, t = [], t0
    for _ in range(n):
        for name in per_call:
            out.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": 4.0})
            t += 10.0
    return out


def _marks(lo, hi):
    return [{"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)", "ts": t, "dur": 1.0} for t in (lo, hi)]


def _learning_window(calls, lost=0, t_end=400):
    """Three markers: one call between the first two, then `calls` calls,
    `lost` of their first records missing."""
    return _marks(-5, 25) + [{"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)", "ts": t_end,
                              "dur": 1.0}] + _calls(1, t0=0.0) + _calls(calls, t0=30.0)[lost:]


@pytest.mark.parametrize("names,per_call", [(["pairing_kernel"], 1), (["pairing_kernel", "Kernel2"], 2),
                                            (None, 2)])
def test_window_us_refuses_a_window_that_lost_records(names, per_call):
    whole = _learning_window(10)  # the learning call, then 10 calls of 2 kernels: 20 records
    assert profiling.window_us(whole, names, 10, learn=True) == 4.0 * 10 * per_call
    # the first records of the calls lost, every marker there: the count is
    # short, a multiple of the calls (10 records lost) or not
    for lost in (2, 1, 3, 10):
        assert profiling.window_us(_learning_window(10, lost=lost), names, 10, learn=True) is None
    # records lost in the middle, and a window of more calls' kernels than it ran
    middle = _learning_window(10)
    assert profiling.window_us(middle[:12] + middle[14:], names, 10, learn=True) is None
    assert profiling.window_us(_learning_window(11), names, 10, learn=True) is None


def test_window_us_learns_the_per_call_count_between_its_first_two_markers():
    names = ["pairing_kernel", "Kernel2"]
    assert profiling.window_us(_learning_window(10), names, 10, learn=True) == 4.0 * 20
    assert profiling.window_us(_learning_window(10), None, 10, learn=True) == 4.0 * 20
    assert profiling.window_us(_learning_window(10, lost=10), names, 10, learn=True) is None  # 10 of 20
    assert profiling.window_us(_learning_window(10)[1:], names, 10, learn=True) is None  # a marker lost
    # the learning call's records lost: its count no longer matches the calls'
    assert profiling.window_us([e for i, e in enumerate(_learning_window(10)) if i not in (3, 4)], names, 10,
                               learn=True) is None


def test_device_ms_refuses_short_and_overlong_windows_and_grows_the_fillers(monkeypatch):
    """Scripted profiler windows: one that lost two calls' records (every
    marker there) and one that lost a marker, each run again with 4x the
    fillers; one whose kernels outlast the CUDA events and one whose
    kernels (20 x 4 us) fall short of the events' 2 ms less the 0.05 ms of
    enqueueing and 50 us a kernel (the card left idle with work queued),
    each run again as it was (wrong durations, no lost record); then a
    whole one, whose time is returned."""
    windows = [(_learning_window(10, lost=4), 1.0, 1.0), (_learning_window(10), 0.015, 0.01),
               (_learning_window(10)[1:], 1.0, 1.0), (_learning_window(10), 2.0, 0.05),
               (_learning_window(10), 0.2, 0.05)]
    seen = []

    def window(fn, calls, fillers, learn):
        seen.append((calls, fillers, learn))
        return windows[len(seen) - 1]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "_profiled_window", window)
    monkeypatch.setattr(profiling, "WINDOW", {"fillers": 16, "raised": 0, "refused": []})
    ms = profiling.device_ms(lambda: None, ["pairing_kernel"], calls=10)
    assert ms == pytest.approx(0.004)  # 10 kernels of 4 us over 10 calls
    assert seen == [(10, 16, True), (10, 64, True), (10, 64, True), (10, 256, True), (10, 256, True)]
    refused = profiling.WINDOW["refused"]
    assert [r["fillers"] for r in refused] == [16, 64, 64, 256] and profiling.WINDOW["raised"] == 2
    assert "8 kernels where 10 calls launch 10 x 1" in refused[0]["reason"]
    assert "0.0400 ms of the counted kernels, 0.0800 of all, in 0.0150 ms of CUDA events" in refused[1]["reason"]
    assert "2 of 3 markers" in refused[2]["reason"]
    assert "0.0800 of all, in 2.0000 ms of CUDA events, 0.0500 ms of them enqueueing" in refused[3]["reason"]
    assert profiling.WINDOW["last"]["device_ms"] == pytest.approx(0.04)


def test_device_ms_takes_kernels_within_the_clocks_agreement(monkeypatch):
    """20 records of 4 us in 79 us of events: within a record's 1 us a
    kernel of them, so the window stands."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "_profiled_window", lambda fn, calls, fillers, learn: (_learning_window(10), 0.079,
                                                                                         0.079))
    monkeypatch.setattr(profiling, "WINDOW", {"fillers": 16, "raised": 0, "refused": []})
    assert profiling.device_ms(lambda: None, ["Kernel2"], calls=10) == pytest.approx(0.004)
    assert profiling.WINDOW["refused"] == []


def test_device_ms_raises_after_windows_with_wrong_durations(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "_profiled_window", lambda fn, calls, fillers, learn: (_learning_window(10), 0.01,
                                                                                         0.01))
    monkeypatch.setattr(profiling, "WINDOW", {"fillers": 16, "raised": 0, "refused": []})
    with pytest.raises(ValueError, match="wrong durations"):
        profiling.device_ms(lambda: None, ["pairing_kernel"], calls=10)
    assert len(profiling.WINDOW["refused"]) == profiling.DURATION_RETRIES and profiling.WINDOW["fillers"] == 16


def test_device_ms_without_the_exact_count_takes_two_markers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "_profiled_window",
                        lambda fn, calls, fillers, learn: (_marks(-5, 400) + _calls(calls)[1:], 0.06, 0.05))
    monkeypatch.setattr(profiling, "WINDOW", {"fillers": 16, "raised": 0, "refused": []})
    assert profiling.device_ms(lambda: None, None, calls=5, exact_count=False) == pytest.approx(9 * 4.0 / 5 / 1e3)


def test_device_ms_raises_when_every_window_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "_profiled_window",
                        lambda fn, calls, fillers, learn: (_learning_window(calls, lost=1), 1.0, 1.0))
    monkeypatch.setattr(profiling, "WINDOW", {"fillers": profiling.MAX_FILLERS // 4, "raised": 0, "refused": []})
    with pytest.raises(ValueError, match="lost records"):
        profiling.device_ms(lambda: None, ["pairing_kernel"], calls=4)
    assert [r["fillers"] for r in profiling.WINDOW["refused"]] == [profiling.MAX_FILLERS // 4, profiling.MAX_FILLERS]
