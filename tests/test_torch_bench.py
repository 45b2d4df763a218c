"""The port's bench (plutus_halo2_tpu_torch/bench.py, the counterpart of
bench.py and tools/bench_rows.py) on the CPU, every kernel through its
plain version, at batch 8 and one timed call:

- the headline, exact and MSM rows (the GWC19 and lookup_table rows in
  tests/test_torch_bench_rows.py, so that the two runs go to two test
  workers): every verdict assert holds (the bench raises otherwise), each
  row carries bench.py's metric name and keys (compile_sec read as
  warmup_sec, no vs_baseline: the port states no TPU baseline; the RLC row
  adds host_syncs_per_call), the headline is printed last, and the rows
  land in the --out file only, stamped with the date;
- the K = 64 MSM row at --msm-batch 2, held by the bench against
  ops/curve.msm_windowed in affine coordinates and row 0 against the spec's
  MSM: a wrong MSM output raises before anything is timed;
- the bench raises without a card unless asked for the CPU."""

import ast
import json
import os

import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch import bench  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

# bench.py's row keys (bench.py:161-183, :208-218): every verification row,
# the aggregate mode's, the RLC rows' and the headline's own, the MSM row's
JAX_ROW = {"metric", "value", "unit", "batch", "steady_state_sec", "latency_sec", "compile_sec", "msm_terms",
           "y_hints", "device", "subgroup"}
JAX_AGGREGATE = {"subgroup_rounds"}
JAX_RLC = {"mode", "rlc_group", "traffic", "corrupted_row_steady_sec", "corrupted_row_proofs_per_sec"}
JAX_HEADLINE = {"vs_baseline"}
JAX_MSM = {"metric", "value", "unit", "K", "batch", "steady_state_sec", "compile_sec", "device"}


def _jax_keys(func: str) -> set:
    """The string keys bench.py's function writes into its row dicts."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def _port(jax_keys: set, rlc: bool = False) -> set:
    return (jax_keys - {"compile_sec", "vs_baseline"}) | {"warmup_sec"} | ({"host_syncs_per_call"} if rlc else set())


def check_verification_row(row, batch):
    """An exact-mode row of the default aggregate mode: bench.py's keys."""
    assert set(row) - {"date", "commit"} == _port(JAX_ROW | JAX_AGGREGATE)
    assert row["batch"] == batch and row["y_hints"] is True and row["subgroup"] == "aggregate"
    assert row["device"] == "cpu" and row["value"] == pytest.approx(batch / row["steady_state_sec"])


def test_jax_row_keys_are_bench_pys():
    assert JAX_ROW | JAX_AGGREGATE | JAX_RLC | JAX_HEADLINE <= _jax_keys("_bench_circuit")
    assert JAX_MSM <= _jax_keys("_bench_msm")


def test_bench_rows_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "bench_details.json"
    rows = bench.main(["--cpu", "--batch", "8", "--iters", "1", "--msm-batch", "2", "--rows", "headline", "exact",
                       "msm", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    printed = [json.loads(line) for line in lines]
    metrics = ["g1_msm_points_per_sec", "simple_mul_halo2_exact_verifications_per_sec_per_chip",
               "simple_mul_halo2_verifications_per_sec_per_chip"]
    assert [r["metric"] for r in printed] == metrics  # the headline last
    assert printed[-1]["metric"] == bench.HEADLINE
    by = {r["metric"]: r for r in rows}
    check_verification_row(by[metrics[1]], 8)
    assert by[metrics[1]]["msm_terms"] == [16]
    head = by[bench.HEADLINE]
    assert set(head) - {"date", "commit"} == _port(JAX_ROW | JAX_AGGREGATE | JAX_RLC | JAX_HEADLINE, rlc=True)
    assert (head["rlc_group"], head["traffic"], head["host_syncs_per_call"]) == (8, "honest", 0)
    assert head["msm_terms"] == [16, 8]
    msm = by["g1_msm_points_per_sec"]
    assert set(msm) - {"date", "commit"} == _port(JAX_MSM)
    assert (msm["K"], msm["batch"]) == (64, 2) and msm["value"] == pytest.approx(128 / msm["steady_state_sec"])
    with open(out) as f:
        written = json.load(f)
    assert [r["metric"] for r in written] == metrics and all("date" in r for r in written)


def test_the_msm_row_holds_the_kernel_before_timing(monkeypatch):
    calls = []

    def wrong(points, scalars):
        calls.append(1)
        return tc.identity((points.shape[0],), points.device)

    monkeypatch.setattr(bench.cuda_curve, "msm", wrong)
    with pytest.raises(AssertionError, match="msm_windowed"):
        bench.bench_msm(2, 3, torch.device("cpu"))
    assert calls == [1]  # the checked call only: nothing was timed


def test_bench_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--rows", "msm", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
