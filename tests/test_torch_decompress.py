"""Hinted decompression in the port (ops/curve.decompress(..., y_hint=), the
plain version of csrc/decompress.cu) against the JAX package: limb for limb
with jc.decompress on the case grid of test_pallas_decompress.py:18-48
(honest encodings with either root as the hint, infinity and bad infinity,
x >= p, a non-square x, a missing compressed flag, a wrong hint); the
oversized-hint reading (mod 2^384) against make_decompress_kernel in
interpret mode; the fused variant's per-row subgroup verdicts; and
TorchVerifier.compute_y_hints against JaxVerifier.compute_y_hints. On the
card (``gpu``-marked, ``python -m pytest tests/test_torch_decompress.py -m
gpu --noconftest``; JAX is imported only inside the CPU tests that need it)
verify() without y-hints, the hintless decompress kernel, gives the hinted
verdicts."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve, cuda_field  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.field import P  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

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
    import jax

    from plutus_halo2_tpu.ops import curve as jc

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
    import jax

    from plutus_halo2_tpu.ops.pallas_curve import make_decompress_kernel

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
    from plutus_halo2_tpu.ops import curve as jc

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
    import jax

    from plutus_halo2_tpu.ops import curve as jc

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
    from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul
    from plutus_halo2_tpu.models.verifier_jax import JaxVerifier
    from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk
    from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json

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


@pytest.mark.gpu
def test_card_hintless_verdicts_equal_hinted():
    """verify() on the card without y-hints (the hintless decompress kernel)
    and with them (the fused hinted kernel): the same verdicts on 64 rows of
    the valid simple_mul proof with its invalid twin every 8th row, a
    bit-flipped row and a row whose first commitment is a point outside G1;
    each replay of the hintless program launches the hintless kernel once
    and the Fp pow kernel never, the hinted one neither."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")

    def read(name):
        with open(os.path.join(ART, f"simple_mul_{name}")) as f:
            return f.read().strip()

    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(read("vk.json")))
    B = 64
    batch = np.stack([np.frombuffer(bytes.fromhex(read("proof.hex")), np.uint8)] * B).copy()
    want = np.ones(B, bool)
    batch[3::8] = np.frombuffer(bytes.fromhex(read("proof_invalid.hex")), np.uint8)
    want[3::8] = False
    batch[5, 100] ^= 0x40
    batch[6, 0:48] = np.frombuffer(rc.g1_compress(_nonsubgroup_point()), np.uint8)
    want[[5, 6]] = False
    v = TorchVerifier(plan)
    pis = v.encode_public_inputs([parse_public_inputs(read("public_input.hex"))] * B)
    hints = v.compute_y_hints(batch)
    counters = (cuda_curve.decompress_hintless, cuda_field.fp_pow, cuda_curve.decompress_hinted)
    for _ in range(2):  # the capture, then a replay
        runs = {}
        for name, h in (("hintless", None), ("hinted", hints)):
            before = [f.launches for f in counters]
            runs[name] = v.verify(batch, pis, h, torch.Generator().manual_seed(1)).cpu().tolist()
            runs[name + " launches"] = [f.launches - b for f, b in zip(counters, before)]
        assert runs["hintless"] == runs["hinted"] == want.tolist()
        assert runs["hintless launches"] == [1, 0, 0] and runs["hinted launches"] == [0, 0, 1]
    assert v.programs.replays == 2
