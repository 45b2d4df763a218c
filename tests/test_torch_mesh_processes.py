"""The port's mesh layer across processes (plutus_halo2_tpu_torch/parallel/
mesh.py over torch.distributed gloo on the CPU, every kernel through its
plain version; tools/multihost_smoke.launch spawns the ranks with a
file:// store in a temporary directory and bounds every join):

- four ranks with one mesh entry each, dp 2 x mp 2: each mp group spans two
  processes, and verify_2d gives the spec's verdicts on every rank (the
  JAX package's shard_map all-gathers over mp wherever the group lies);
  the sharded MSM over the four ranks equals the spec's;
- two ranks owning 1 and 3 entries: the dp x mp grid has one mp group
  across the two processes and one inside rank 1, and the sharded MSM
  gathers unequal entry counts (padded with identity points); both against
  the spec."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plutus_halo2_tpu_torch.refimpl.verifier import verify  # noqa: E402
from plutus_halo2_tpu_torch.tools import multihost_smoke  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set  # noqa: E402

BATCH = 4


@functools.lru_cache(maxsize=None)
def _spec_verdicts():
    """The spec verifier's verdicts on the workers' rows: the committed
    simple_mul proof, bit-flipped at multihost_smoke.BAD_ROW."""
    plan, proof, _bad, pis = load_set("simple_mul")
    flipped = bytearray(proof)
    flipped[100] ^= 0x40
    rows = [bytes(flipped) if i == multihost_smoke.BAD_ROW else proof for i in range(BATCH)]
    cache = {}
    return [cache.setdefault(r, verify(plan, r, pis)[0]) for r in rows]


def _run(nproc, local):
    results = multihost_smoke.launch(nproc, BATCH, cpu=True, timeout_s=300, local=local, checks=("2d", "msm"))
    multihost_smoke.check(results)
    return results


def test_verify_2d_with_mp_groups_across_processes():
    results = _run(4, 1)
    want = _spec_verdicts()
    assert want == [True, True, True, False]
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    for r in results:
        assert r["verdicts_2d"] == want and r["msm_ok"] is True
        assert "{'dp': 2, 'mp': 2}" in r["mesh_2d"] and "ranks [0, 1, 2, 3]" in r["mesh_2d"]


def test_unequal_entries_per_process():
    results = _run(2, [1, 3])
    for r in results:
        assert r["verdicts_2d"] == _spec_verdicts() and r["msm_ok"] is True
        assert "ranks [0, 1, 1, 1]" in r["mesh_2d"]
