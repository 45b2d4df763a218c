"""The port's stage probe and profiling harness on the CPU
(plutus_halo2_tpu_torch/tools/perf_probe.py, utils/profiling.py): the
probe's stages run and check themselves, both probes refuse to run without
a card unless asked for the CPU, StageTimer reports as the JAX package's,
torch_trace writes a Chrome trace, device_busy_share reads one right, and
the MSM entry point's window width."""

import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from plutus_halo2_tpu.utils import profiling as jprof  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FR_SPEC  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.tools import mma_probe, perf_probe  # noqa: E402
from plutus_halo2_tpu_torch.utils import profiling  # noqa: E402


def test_stage_probe_runs_and_checks_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("PROBE_MSM_K", "3")
    res = perf_probe.main(["2", "mul", "blake", "msm", "--device", "cpu"])
    assert set(res) == {"mont_mul plain x1", "mont_mul kernel x1", "blake2b_256 1152B", "msm plain K=3"}
    assert all(ms > 0 for ms in res.values())
    assert capsys.readouterr().out.startswith("device=cpu batch=2 card=cpu")


def test_stage_probe_catches_a_wrong_result(monkeypatch):
    monkeypatch.setattr(perf_probe, "blake2b_256", lambda m: torch.zeros((m.shape[0], 32), dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="blake2b_256 wrong"):
        perf_probe.main(["2", "blake", "--device", "cpu"])


@pytest.mark.parametrize("accept_all", [False, True], ids=["exact", "accept_all"])
def test_subgroup_stage_holds_a_row_outside_g1(monkeypatch, accept_all):
    """subk's row 1 holds a point outside G1: the stage passes on the real
    test and catches a kernel that accepts every row."""
    monkeypatch.setenv("PROBE_SUB_K", "4")
    monkeypatch.setenv("PROBE_SUB_ROUNDS", "1")
    if not accept_all:
        assert list(perf_probe.main(["3", "subk", "--device", "cpu"])) == ["subgroup kernel K=4 r=1"]
        return
    monkeypatch.setattr(cuda_curve, "aggregate_subgroup_check",
                        lambda pts, w: torch.ones(pts.shape[0], dtype=torch.bool))
    with pytest.raises(RuntimeError, match="subgroup kernel wrong"):
        perf_probe.main(["3", "subk", "--device", "cpu"])


def test_stage_probe_rejects_unknown_stages():
    with pytest.raises(SystemExit):
        perf_probe.main(["2", "mull", "--device", "cpu"])


@pytest.mark.parametrize("probe,argv", [(perf_probe, ["2", "mul"]), (mma_probe, ["16"])],
                         ids=["perf_probe", "mma_probe"])
def test_probes_raise_without_a_card(monkeypatch, probe, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(argv)


def test_stage_timer_reports_the_jax_keys():
    reports = []
    for timer in (profiling.StageTimer(), jprof.StageTimer(), profiling.StageTimer(device="cpu")):
        for name in ("parse", "verify", "parse"):
            with timer.stage(name):
                pass
        reports.append(json.loads(timer.report()))
    assert list(reports[0]) == list(reports[1]) == list(reports[2]) == ["parse", "verify"]
    assert all(isinstance(v, float) for r in reports for v in r.values())


def test_torch_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.torch_trace(str(tmp_path / "t")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(tmp_path / "t") == ["trace.json.gz"]
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    with pytest.raises(ValueError, match="no device activity"):
        profiling.device_busy_share(path)  # a CPU trace has no device intervals


def test_device_busy_share_of_a_synthetic_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "verify", "ts": 100, "dur": 100},   # the window: 100..200
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 110, "dur": 20},         # 110..130
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 120, "dur": 20},         # overlaps: 110..140
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 150, "dur": 10},     # 150..160
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 105, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 170},
        {"ph": "X", "cat": "kernel", "name": "d", "ts": 155, "dur": 3},          # inside c
    ]
    assert profiling.device_busy_share(events) == pytest.approx(0.4)
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    assert profiling.device_busy_share(str(p)) == pytest.approx(0.4)


def _msm_case(K, B=3, seed=11):
    rng = np.random.default_rng(seed)
    pts = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=K)]
    sc = [[int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(K)] for _ in range(B)]
    pts_t = torch.from_numpy(np.stack([np.stack([tc.host_point_to_mont(p) for p in pts])] * B))
    sc_t = torch.from_numpy(np.stack([np.stack([FR_SPEC.encode(s) for s in row]) for row in sc]))
    return pts, sc, pts_t, sc_t


@pytest.mark.parametrize("wbits", [4, 5])
def test_msm_takes_the_pallas_window_widths(wbits):
    pts, sc, pts_t, sc_t = _msm_case(3)
    out = cuda_curve.msm(pts_t, sc_t, wbits=wbits)  # CPU: the plain MSM
    for b in range(len(sc)):
        assert tc.host_point_from_mont(out[b].numpy()) == rc.g1_msm(sc[b], pts)


@pytest.mark.parametrize("wbits", [3, 6, 0])
def test_msm_rejects_other_window_widths(wbits):
    _pts, _sc, pts_t, sc_t = _msm_case(1, B=1)
    with pytest.raises(ValueError, match="wbits"):
        cuda_curve.msm(pts_t, sc_t, wbits=wbits)


def test_device_time_by_name_sums_each_kind():
    events = [
        {"ph": "X", "cat": "kernel", "name": "pairing_kernel", "ts": 0, "dur": 90},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 90, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 95, "dur": 3},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 99, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 89, "dur": 10},
    ]
    assert profiling.device_time_by_name(events) == [("pairing_kernel", 1, 90.0), ("add", 2, 5.0),
                                                     ("Memcpy HtoD", 1, 1.0)]
    assert profiling.device_time_by_name(events, top=1) == [("pairing_kernel", 1, 90.0)]
