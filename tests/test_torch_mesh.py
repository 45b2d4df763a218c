"""The port's mesh layer (plutus_halo2_tpu_torch/parallel/mesh.py) on the
CPU, every kernel through its plain version; verdicts and points exactly
(there is no tolerance in a verdict or a group element):

- on a ["cpu"] * 4 mesh, data_parallel_verify (the default hintless
  aggregate mode, one set of weights for every shard; with y-hints on a
  ["cpu"] * 2 mesh, a corrupted hint rejecting its row) and verify_2d
  (dp 2 x mp 2: the multi-open MSM split over mp) at B = 8, with a
  bit-flipped row and the committed invalid twin, give exactly
  TorchVerifier.verify()'s verdicts and the JAX spec's; msm_term_counts
  stays the unsharded K and the MSM hook is restored;
- shards on two devices other than the verifier's own ("cpu:1", "cpu:2"):
  one replica each, on a thread each, built once and reused;
- lookup_table and atms_with_lookups (dryrun_multichip's third leg, K = 36:
  more than one point on an MSM lane) through the DP mesh: the port's spec
  verifier's verdicts;
- the hook on simple_mul GWC19 (K = 3 and 17 over mp 2: padded slices)
  gives the unsharded core's el and er;
- shard_map_msm against the JAX package's shard_map_msm on 4 of its 8
  virtual CPU devices (tests/conftest.py), limb for limb and in affine, at
  K = 11 (not a multiple of 4), and sharded_msm on the same points;
  sharded_msm against the spec's MSM at ragged K, and against the JAX
  package's sharded_msm (slow: its compile takes minutes on a CPU);
- a two-process gloo run (tools/multihost_smoke.launch) of the DP
  verification and a cross-rank MSM, bounded by a join timeout;
- JAX's data_parallel_verify on the same rows (slow: the jitted verifier)."""

import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models import circuits as j_circuits  # noqa: E402
from plutus_halo2_tpu.ops import curve as jc  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.refimpl.verifier import verify as j_verify  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FR_SPEC  # noqa: E402
from plutus_halo2_tpu_torch.parallel import mesh as pm  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.field import Q  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.verifier import verify  # noqa: E402
from plutus_halo2_tpu_torch.tools import multihost_smoke  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set, read_set  # noqa: E402

B = 8
CPU4 = ["cpu"] * 4


@functools.lru_cache(maxsize=None)
def _batch():
    """(plan, JAX plan, (B, PLEN) proofs, public inputs): the committed
    simple_mul proof, bit-flipped on row 3, its invalid twin on row 6."""
    plan, proof, bad, pis = load_set("simple_mul")
    jplan = j_plan_from_vk(j_circuits.SimpleMulCircuit(), j_vk_from_json(read_set("simple_mul")["vk.json"]))
    batch = np.stack([np.frombuffer(proof, np.uint8)] * B).copy()
    batch[3, 100] ^= 0x40
    batch[6] = np.frombuffer(bad, np.uint8)
    return plan, jplan, batch, pis


@pytest.fixture(scope="module")
def sm():
    """(verifier, proofs, encoded inputs, the spec's verdicts, verify()'s)."""
    plan, jplan, batch, pis = _batch()
    spec = {}
    want = [spec.setdefault(row.tobytes(), j_verify(jplan, row.tobytes(), pis)[0]) for row in batch]
    v = TorchVerifier(plan, device="cpu")
    pis_l = v.encode_public_inputs([pis] * B)
    ref = v.verify(batch, pis_l, None, torch.Generator().manual_seed(1)).numpy()
    assert ref.tolist() == want == [i not in (3, 6) for i in range(B)]
    return v, batch, pis_l, want, ref


def test_data_parallel_verify(sm):
    v, batch, pis_l, want, ref = sm
    mesh = pm.make_mesh(CPU4)
    got = pm.data_parallel_verify(v, mesh, batch, pis_l, sub_rng=torch.Generator().manual_seed(2))
    assert got.dtype == bool and got.tolist() == ref.tolist() == want
    assert v.msm_term_counts == [16]


def test_data_parallel_verify_with_y_hints(sm):
    """Hints split with their rows: a corrupted hint rejects only its row
    (default-mode verdicts of rows 0-3, bit-flipped row 3)."""
    v, batch, pis_l, _want, ref = sm
    hints = v.compute_y_hints(batch[:4])
    hints[1, 2, 0] ^= 1
    got = pm.data_parallel_verify(v, pm.make_mesh(["cpu"] * 2), batch[:4], pis_l[:4],
                                  sub_rng=torch.Generator().manual_seed(5), y_hints=hints)
    assert got.tolist() == [True, False, True, False] == [r and i != 1 for i, r in enumerate(ref[:4])]


def test_verify_2d(sm):
    v, batch, pis_l, want, ref = sm
    mesh = pm.make_mesh_2d(dp=2, mp=2, devices=CPU4)
    got = pm.verify_2d(v, mesh, batch, pis_l, sub_rng=torch.Generator().manual_seed(3))
    assert got.tolist() == ref.tolist() == want
    assert v.msm_term_counts == [16]  # the unsharded K, as the JAX verifier records it
    assert v.msm is cuda_curve.msm  # the hook restored


def test_replicas_on_other_devices(sm):
    """Shards on devices other than the verifier's own run on replicas built
    once per device and reused by later calls, on a thread each: "cpu:1"
    and "cpu:2" are two distinct devices whose tensors live on the CPU."""
    v, batch, pis_l, _want, ref = sm
    got = pm.data_parallel_verify(v, pm.make_mesh(["cpu:1", "cpu:2"]), batch[2:4], pis_l[2:4],
                                  sub_rng=torch.Generator().manual_seed(7))
    assert got.tolist() == ref[2:4].tolist() == [True, False]
    reps = dict(pm._REPLICAS[v])
    assert sorted(d for d, _mode, _rounds in reps) == ["cpu:1", "cpu:2"]
    assert all(r is not v and r.state is v.state and r.msm_term_counts == [16] for r in reps.values())
    # a later call's lookup returns the same replicas, and the own device the verifier
    assert [pm._replica(v, torch.device(d)) for d, _m, _r in reps] == list(reps.values())
    assert pm._replica(v, torch.device("cpu")) is v and pm._REPLICAS[v] == reps


def test_data_parallel_verify_lookup_table():
    """A lookup circuit through the DP mesh (the honest proof, the invalid
    twin, a corrupted proof scalar), the spec's verdicts row by row."""
    plan, proof, bad, pis = load_set("lookup_table")
    v = TorchVerifier(plan, device="cpu")
    batch = np.stack([np.frombuffer(p, np.uint8) for p in (proof, bad, proof, proof)]).copy()
    batch[3, list(v.layout.scalar_offsets.values())[0] + 3] ^= 0x40
    got = pm.data_parallel_verify(v, pm.make_mesh(["cpu"] * 2), batch, v.encode_public_inputs([pis] * 4),
                                  sub_rng=torch.Generator().manual_seed(6))
    assert got.tolist() == [verify(plan, row.tobytes(), pis)[0] for row in batch] == [True, False, True, False]
    assert v.msm_term_counts == [19]


def test_data_parallel_verify_atms_with_lookups():
    """dryrun_multichip's third leg (__graft_entry__.py:135-177): the
    atms_with_lookups plan, rebuilt from the committed artifacts, through
    the DP mesh with the bit-flipped row at min(1, n - 1); the spec's
    verdicts row by row, and the multi-open MSM at K = 36."""
    plan, proof, _bad, pis = load_set("atms_with_lookups")
    v = TorchVerifier(plan, device="cpu")
    batch = np.stack([np.frombuffer(proof, np.uint8)] * 2).copy()
    batch[1, 100] ^= 0x40
    got = pm.data_parallel_verify(v, pm.make_mesh(["cpu"] * 2), batch, v.encode_public_inputs([pis] * 2),
                                  sub_rng=torch.Generator().manual_seed(8))
    assert got.tolist() == [verify(plan, row.tobytes(), pis)[0] for row in batch] == [True, False]
    assert v.msm_term_counts == [36]


def test_msm_hook_on_gwc_matches_unsharded_core():
    """GWC19's two MSMs (K = 3, 17) split over mp 2, both with a padded
    slice: the pairing sides equal the unsharded core's in affine, and the
    hook leaves msm_term_counts at the unsharded K."""
    plan, proof, _bad, pis = load_set("simple_mul_gwc19")
    v = TorchVerifier(plan, device="cpu", subgroup_check="off")
    rows, pis_l = np.frombuffer(proof, np.uint8)[None].copy(), v.encode_public_inputs([pis])
    el0, er0, ok0 = v.core(rows, pis_l)
    v.msm = functools.partial(pm.shard_map_msm, axis=pm.make_mesh(["cpu"] * 2, axis="mp"))
    el1, er1, ok1 = v.core(rows, pis_l)
    assert v.msm_term_counts == [3, 17]
    for a, b in ((el0, el1), (er0, er1)):
        assert tc.host_point_from_mont(a[0].numpy()) == tc.host_point_from_mont(b[0].numpy()) is not None
    assert ok0.tolist() == ok1.tolist() == [True]


def _msm_inputs(seed, K, rows=None):
    """Seeded points (an identity among them) and scalars (a zero), as
    port limbs, and the spec's sum."""
    rng = random.Random(seed)
    host = [rc.g1_mul(rc.G1_GEN, rng.randrange(1, 2**64)) for _ in range(K)]
    host[0] = None
    scal = [rng.randrange(Q) for _ in range(K)]
    scal[min(1, K - 1)] = 0
    pts = np.stack([tc.host_point_to_mont(p) for p in host])
    scs = np.stack([FR_SPEC.encode(s) for s in scal])
    if rows is not None:
        pts, scs = np.stack([pts] * rows), np.stack([scs] * rows)
    return pts, scs, rc.g1_msm(scal, host)


def _jax_cpu(n):
    import jax

    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"needs {n} JAX CPU devices (tests/conftest.py makes 8), have {len(devs)}")
    return devs[:n]


def test_shard_map_msm_matches_jax():
    """K = 11 over 4 entries (one padded slice) at B = 2, as the JAX
    package's test_shard_map_msm_batched runs its own."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from plutus_halo2_tpu.parallel.mesh import shard_map, shard_map_msm

    pts, scs, want = _msm_inputs(42, 11, rows=2)
    fn = shard_map(lambda p, s: shard_map_msm(p, s, "mp"), mesh=Mesh(np.asarray(_jax_cpu(4)), ("mp",)),
                   in_specs=(P(), P()), out_specs=P(), check_rep=False)
    j_out = np.asarray(jax.jit(fn)(pts.astype(np.uint32), scs.astype(np.uint32))).astype(np.int64)
    out = pm.shard_map_msm(torch.from_numpy(pts), torch.from_numpy(scs), pm.make_mesh(CPU4, axis="mp"))
    assert np.array_equal(out.numpy(), j_out)
    for b in range(2):
        assert tc.host_point_from_mont(out[b].numpy()) == jc.host_point_from_mont(j_out[b]) == want
    one = pm.sharded_msm(pm.make_mesh(CPU4, axis="shard"), pts[0], scs[0])  # the standalone form
    assert tc.host_point_from_mont(one.numpy()) == jc.host_point_from_mont(j_out[0])


@pytest.mark.parametrize("n,K", [(4, 7), (3, 16), (2, 1)])
def test_sharded_msm_matches_spec(n, K):
    """Ragged K (padded with identity points and zero scalars), a K below
    the entry count included."""
    pts, scs, want = _msm_inputs(K, K)
    out = pm.sharded_msm(pm.make_mesh(["cpu"] * n, axis="shard"), pts, scs)
    assert out.shape == (3, 25) and tc.host_point_from_mont(out.numpy()) == want


@pytest.mark.slow
def test_sharded_msm_matches_jax_sharded_msm():
    """The JAX package's sharded_msm (K a multiple of the mesh, as it
    requires) on 4 virtual CPU devices; its compile takes minutes."""
    from plutus_halo2_tpu.parallel.mesh import make_mesh, sharded_msm

    pts, scs, want = _msm_inputs(41, 8)
    j_out = np.asarray(sharded_msm(make_mesh(_jax_cpu(4), axis="shard"), pts.astype(np.uint32),
                                   scs.astype(np.uint32))).astype(np.int64)
    out = pm.sharded_msm(pm.make_mesh(CPU4, axis="shard"), pts, scs)
    assert tc.host_point_from_mont(out.numpy()) == jc.host_point_from_mont(j_out) == want


def test_mesh_shapes_and_placement():
    m = pm.make_mesh_2d(dp=2, mp=2, devices=CPU4)
    assert m.shape == {"dp": 2, "mp": 2} and m.size == 4 and not m.distributed
    assert m.ranks.tolist() == [[0, 0], [0, 0]]
    x = torch.arange(12).reshape(6, 2)
    (chunks,) = pm.shard_batch(pm.make_mesh(["cpu"] * 3), x)
    assert [c.tolist() for c in chunks] == [x[0:2].tolist(), x[2:4].tolist(), x[4:6].tolist()]
    (dp_chunks, none) = pm.shard_batch(m, x[:4], None, axis_name="dp")
    assert none is None and [c.shape[0] for c in dp_chunks] == [2, 2]


def test_mesh_refusals(sm):
    v, batch, pis_l, _want, _ref = sm
    with pytest.raises(ValueError, match="dp\\*mp"):
        pm.make_mesh_2d(dp=3, mp=2, devices=CPU4)
    with pytest.raises(ValueError, match="equal shards"):
        pm.shard_batch(pm.make_mesh(["cpu"] * 3), batch)
    with pytest.raises(ValueError, match="axes"):
        pm.verify_2d(v, pm.make_mesh(CPU4), batch, pis_l)
    with pytest.raises(ValueError, match="one-axis mesh"):
        pm.sharded_msm(pm.make_mesh_2d(dp=2, mp=2, devices=CPU4), *_msm_inputs(1, 4)[:2])


def test_mesh_defaults_to_the_cards(monkeypatch):
    """Without devices a mesh takes every card, and raises without one
    rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.init_distributed(world_size=1, rank=0)


def test_two_process_gloo():
    """Two spawned ranks (gloo): the DP verification of a 4-row batch with
    one bit-flipped row across both, the verdicts all-gathered on each, and
    a K = 7 MSM sharded across the ranks; every join is bounded."""
    results = multihost_smoke.launch(2, batch=4, cpu=True, timeout_s=300)
    multihost_smoke.check(results)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["verdicts"] == [True, True, True, False] and "ranks [0, 1]" in r["mesh"] for r in results)


@pytest.mark.slow
def test_data_parallel_verify_matches_jax(sm):
    """The JAX package's data_parallel_verify (its jitted verifier) on 4 of
    its virtual CPU devices, on the same rows."""
    from plutus_halo2_tpu.models.verifier_jax import JaxVerifier
    from plutus_halo2_tpu.parallel.mesh import data_parallel_verify, make_mesh

    _v, batch, _pis_l, want, ref = sm
    _plan, jplan, _batch_rows, pis = _batch()
    jv = JaxVerifier(jplan, use_pallas=False)
    out = data_parallel_verify(jv, make_mesh(_jax_cpu(4)), batch, jv.encode_public_inputs([pis] * B),
                               sub_rng=np.random.default_rng(4))
    assert np.asarray(out).tolist() == ref.tolist() == want
