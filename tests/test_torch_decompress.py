"""Hinted decompression in the port (ops/curve.decompress(..., y_hint=), the
plain version of csrc/decompress.cu) against the JAX package: limb for limb
with jc.decompress on the case grid of test_pallas_decompress.py:18-48
(honest encodings with either root as the hint, infinity and bad infinity,
x >= p, a non-square x, a missing compressed flag, a wrong hint); the
oversized-hint reading (mod 2^384) against make_decompress_kernel in
interpret mode; the fused variant's per-row subgroup verdicts; and
TorchVerifier.compute_y_hints against JaxVerifier.compute_y_hints."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.models.verifier_jax import JaxVerifier  # noqa: E402
from plutus_halo2_tpu.ops import curve as jc  # noqa: E402
from plutus_halo2_tpu.ops.pallas_curve import make_decompress_kernel  # noqa: E402
from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu.refimpl.field import P  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import vk_from_json  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")


def _cases():
    """(48-byte encoding, hint int) rows covering the decision tree (the
    rows of test_pallas_decompress.py:18-48)."""
    rows = []
    g = rc.G1_GEN
    for k in [1, 2, 3, 5, 7, 11]:
        p = rc.g1_mul(g, k)
        enc = rc.g1_compress(p)
        y = p[1]
        rows.append((enc, min(y, P - y)))  # canonical-root hint
        rows.append((enc, max(y, P - y)))  # other-root hint (sign normalizes)
    rows.append((bytes([0xC0] + [0] * 47), 0))  # infinity
    rows.append((bytes([0xC0, 1] + [0] * 46), 0))  # bad infinity (payload bits set)
    xbig = (P + 2).to_bytes(48, "big")  # x >= p
    rows.append((bytes([xbig[0] | 0x80]) + xbig[1:], 3))
    x1 = (1).to_bytes(48, "big")  # rhs = 5 has no square root
    rows.append((bytes([x1[0] | 0x80]) + x1[1:], 12345))
    p = rc.g1_mul(g, 13)
    enc = bytearray(rc.g1_compress(p))
    enc[0] &= 0x7F  # compressed flag missing
    rows.append((bytes(enc), p[1]))
    p = rc.g1_mul(g, 17)
    rows.append((rc.g1_compress(p), p[1] + 1))  # wrong hint for a good point
    return rows


@pytest.fixture(scope="module")
def grid():
    """The cases tiled into a (B, K) = (5, 4) grid."""
    rows = _cases()
    B, K = 5, 4
    raw = np.zeros((B, K, 48), np.uint8)
    hints = np.zeros((B, K, FP_SPEC.L), np.int64)
    for b in range(B):
        for k in range(K):
            enc, hint = rows[(b * K + k) % len(rows)]
            raw[b, k] = np.frombuffer(enc, np.uint8)
            hints[b, k] = FP_SPEC.encode(hint)
    return raw, hints


def test_hinted_decompress_matches_jax(grid):
    raw, hints = grid
    pts, valid = tc.decompress(torch.from_numpy(raw), y_hint=torch.from_numpy(hints))
    jpts, jvalid = jax.jit(lambda r, h: jc.decompress(r, y_hint=h))(raw, hints.astype(np.uint32))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.any() and (~valid).any()
    assert np.array_equal(pts.numpy(), np.asarray(jpts).astype(np.int64))
    # the CPU wrapper of the kernel is its plain version
    kp, kv = cuda_curve.decompress_hinted(torch.from_numpy(raw), torch.from_numpy(hints))
    assert torch.equal(kp, pts) and torch.equal(kv, valid)


def test_hinted_equals_hintless_on_valid_points(grid):
    raw, hints = grid
    pts, valid = tc.decompress(torch.from_numpy(raw), y_hint=torch.from_numpy(hints))
    pts0, valid0 = tc.decompress(torch.from_numpy(raw))
    # the wrong-hint row is the only encoding the hint path rejects alone
    assert (valid <= valid0).all()
    assert torch.equal(pts[valid], pts0[valid])


def test_oversized_hint_read_like_the_pallas_kernel():
    """The hint is read mod 2^384 as make_decompress_kernel reads it: a
    correct root with a junk top limb decodes the true point, a wrong one
    still rejects (test_pallas_decompress.py:127)."""
    p = rc.g1_mul(rc.G1_GEN, 23)
    enc = np.frombuffer(rc.g1_compress(p), np.uint8)
    K, B = 2, 128
    raw = np.broadcast_to(enc, (B, K, 48)).copy()
    hints = np.zeros((B, K, FP_SPEC.L), np.int64)
    hints[:, 0, :] = FP_SPEC.encode(p[1])
    hints[:, 1, :] = FP_SPEC.encode(p[1] + 1)
    hints[:, :, 24] = 7
    hints[1::2, 0, 24] = 0x8000  # a second junk top limb on odd rows
    pts, valid = tc.decompress(torch.from_numpy(raw), y_hint=torch.from_numpy(hints))
    kpts, kvalid = jax.jit(make_decompress_kernel(K, interpret=True))(raw, hints.astype(np.uint32))
    assert np.array_equal(valid.numpy(), np.asarray(kvalid))
    assert np.array_equal(pts.numpy(), np.asarray(kpts).astype(np.int64))
    assert valid[:, 0].all() and not valid[:, 1].any()
    assert np.array_equal(pts[0, 0].numpy(), tc.host_point_to_mont(p))


def _nonsubgroup_point():
    x = 100
    while True:
        rhs = (x**3 + 4) % P
        y = pow(rhs, (P + 1) >> 2, P)
        if y * y % P == rhs and not rc.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


@pytest.mark.parametrize("rounds", [1, 2])
def test_fused_variant_subgroup_verdicts(rounds):
    """The fused variant (weights given) keeps points and valid flags and
    adds the per-row aggregate test of the decoded points: honest rows with
    an infinity encoding pass, a row with a non-subgroup E(Fp) point fails
    (test_pallas_decompress.py:81)."""
    evil = _nonsubgroup_point()
    g = [rc.g1_mul(rc.G1_GEN, 3 + i) for i in range(3)]
    rows = [[g[0], g[1], g[2], None], [g[0], evil, g[2], g[1]], [None] * 4, [g[2], g[0], g[1], g[1]]]
    raw = np.stack([np.stack([np.frombuffer(rc.g1_compress(pt), np.uint8) for pt in row])
                    for row in rows])
    hints = np.stack([np.stack([FP_SPEC.encode(pt[1] if pt is not None else 0) for pt in row])
                      for row in rows])
    w = jc.subgroup_weights(4, rounds=rounds, rng=np.random.default_rng(11))
    raw_t, hints_t = torch.from_numpy(raw), torch.from_numpy(hints)
    pts, valid, sub_ok = cuda_curve.decompress_hinted(raw_t, hints_t, w)
    p0, v0 = cuda_curve.decompress_hinted(raw_t, hints_t)
    assert torch.equal(pts, p0) and torch.equal(valid, v0) and bool(valid.all())
    assert sub_ok.tolist() == [True, False, True, True]


@pytest.mark.slow
def test_fused_variant_matches_jax_aggregate():
    """sub_ok against jc.aggregate_subgroup_check on the JAX package's own
    decoding of the same rows (its eager MSM scan takes about a minute)."""
    evil = _nonsubgroup_point()
    g = [rc.g1_mul(rc.G1_GEN, 5 + i) for i in range(3)]
    rows = [[g[0], None, g[2]], [evil, g[1], g[2]], [g[1], g[1], g[0]]]
    raw = np.stack([np.stack([np.frombuffer(rc.g1_compress(pt), np.uint8) for pt in row])
                    for row in rows])
    hints = np.stack([np.stack([FP_SPEC.encode(pt[1] if pt is not None else 0) for pt in row])
                      for row in rows])
    w = jc.subgroup_weights(3, rounds=1, rng=np.random.default_rng(4))
    _, _, sub_ok = cuda_curve.decompress_hinted(torch.from_numpy(raw), torch.from_numpy(hints), w)
    jpts, _ = jax.jit(lambda r, h: jc.decompress(r, y_hint=h))(raw, hints.astype(np.uint32))
    assert sub_ok.tolist() == np.asarray(jc.aggregate_subgroup_check(jpts, w)).tolist()


def test_compute_y_hints_matches_jax():
    with open(os.path.join(ART, "simple_mul_vk.json")) as f:
        vk_text = f.read()
    with open(os.path.join(ART, "simple_mul_proof.hex")) as f:
        proof = np.frombuffer(bytes.fromhex(f.read().strip()), np.uint8)
    with open(os.path.join(ART, "simple_mul_proof_invalid.hex")) as f:
        bad = np.frombuffer(bytes.fromhex(f.read().strip()), np.uint8)
    batch = np.stack([proof, bad, proof, proof]).copy()
    batch[3, 0] ^= 0x01  # a point x no longer on the curve
    tv = TorchVerifier(plan_from_vk(SimpleMulCircuit(), vk_from_json(vk_text)), device="cpu")
    jv = JaxVerifier(j_plan_from_vk(JSimpleMul(), j_vk_from_json(vk_text)), use_pallas=False)
    got = tv.compute_y_hints(batch)
    assert got.dtype == np.int64 and got.shape == (4, 10, FP_SPEC.L)
    assert np.array_equal(got, jv.compute_y_hints(batch).astype(np.int64))
