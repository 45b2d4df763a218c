"""The port's multi-process smoke (plutus_halo2_tpu_torch/tools/
multihost_smoke.py) with --cpu at a small batch: one process and then two,
each with two mesh entries, each pinned to its own slice of the cores; the
verdicts and the cross-rank MSM exact on every rank, and the summary with
its 1 -> 2 process scaling efficiency written to the file it is given
(never the JAX package's MULTIHOST_SMOKE.json). Every join is bounded."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from plutus_halo2_tpu_torch.tools import multihost_smoke  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_multihost_smoke_writes_its_scaling_efficiency(tmp_path):
    reference = os.path.join(ROOT, "MULTIHOST_SMOKE.json")
    before = os.stat(reference).st_mtime_ns
    out = tmp_path / "smoke.json"
    summary = multihost_smoke.main(["--cpu", "--local", "2", "--batch", "4", "--iters", "1", "--timeout", "300",
                                    "--out", str(out)])
    with open(out) as f:
        written = json.load(f)
    assert written == summary
    assert {"ok", "verdicts", "t1", "t2", "scaling_efficiency_1to2", "backend", "batch"} <= set(written)
    assert written["ok"] is True and written["backend"] == "gloo" and written["batch"] == 4
    assert written["verdicts"] == [True, True, True, False]
    assert written["t1"] > 0 and written["t2"] > 0
    slices, _why = multihost_smoke.core_slices(2)
    if slices:
        assert written["scaling_efficiency_1to2"] == pytest.approx(written["t1"] / (2 * written["t2"]))
        assert written["pinning"] == f"{len(slices[0])} cores a process"
    else:  # too few cores here to give each process a slice: no efficiency, and why
        assert written["scaling_efficiency_1to2"] is None and "not pinned" in written["pinning"]
    assert os.stat(reference).st_mtime_ns == before
