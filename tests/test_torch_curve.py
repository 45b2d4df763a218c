"""The port's G1 code (plutus_halo2_tpu_torch/ops/curve.py) against the JAX
package: RCB15 add/double limb for limb, hintless decompression (blst flags,
x < p, non-residues, infinity) limb for limb on the committed simple_mul
proof's points and on invalid encodings, and the plain MSM (the plain
version of csrc/msm.cu) against jc.msm and the Pallas MSM kernel in
interpret mode, compared in affine coordinates."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.models.layout import build_layout  # noqa: E402
from plutus_halo2_tpu.ops import curve as jc  # noqa: E402
from plutus_halo2_tpu.ops import pallas_curve  # noqa: E402
from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")


def _points(seed, n):
    rng = np.random.default_rng(seed)
    return [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=n)]


def _host(pts):
    return np.stack([tc.host_point_to_mont(p) for p in pts])


def test_host_point_encoding_matches_jax():
    pts = _points(1, 3) + [None]
    assert np.array_equal(_host(pts), np.stack([jc.host_point_to_mont(p) for p in pts]).astype(np.int64))


def test_add_double_match_jax():
    p = _points(2, 4) + [None, None]
    q = _points(3, 3) + [p[0], None, p[1]]  # includes P + P and O + O, O + Q
    hp, hq = _host(p), _host(q)
    s = tc.add(torch.from_numpy(hp), torch.from_numpy(hq)).numpy()
    d = tc.double(torch.from_numpy(hp)).numpy()
    assert np.array_equal(s, np.asarray(jax.jit(jc.add)(hp.astype(np.uint32), hq.astype(np.uint32))))
    assert np.array_equal(d, np.asarray(jax.jit(jc.double)(hp.astype(np.uint32))))
    for i in range(len(p)):
        assert tc.host_point_from_mont(s[i]) == rc.g1_add(p[i], q[i])


def _compressed_cases():
    with open(os.path.join(ART, "simple_mul_vk.json")) as f:
        plan = plan_from_vk(JSimpleMul(), vk_from_json(f.read()))
    with open(os.path.join(ART, "simple_mul_proof.hex")) as f:
        proof = bytes.fromhex(f.read().strip())
    lay = build_layout(plan)
    good = [proof[o : o + 48] for o in lay.point_offsets.values()]
    P = FP_SPEC.N
    x_ge_p = bytearray(P.to_bytes(48, "big"))
    x_ge_p[0] |= 0x80
    bad = [
        bytes(x_ge_p),                                       # x == p
        bytes([good[0][0] & 0x7F]) + good[0][1:],            # compressed flag cleared
        bytes([good[1][0] ^ 0x20]) + good[1][1:],            # sign flipped (still valid)
        bytes([0xC0] + [0] * 47),                            # infinity
        bytes([0xE0] + [0] * 47),                            # infinity with sign: invalid
        bytes([0xC0] + [0] * 46 + [1]),                      # infinity, nonzero payload
    ]
    # an x with no square root of x^3 + 4
    x = 1
    while rc.fp_sqrt((x**3 + 4) % P) is not None:
        x += 1
    nr = bytearray(x.to_bytes(48, "big"))
    nr[0] |= 0x80
    bad.append(bytes(nr))
    return good, bad


def test_decompress_matches_jax_on_proof_points_and_invalid_encodings():
    good, bad = _compressed_cases()
    raw = np.frombuffer(b"".join(good + bad), np.uint8).reshape(-1, 48).copy()
    pts, valid = tc.decompress(torch.from_numpy(raw))
    jpts, jvalid = jax.jit(jc.decompress)(raw)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(pts.numpy(), np.asarray(jpts).astype(np.int64))
    assert valid.numpy().tolist() == [True] * len(good) + [False, False, True, True, False, False, False]
    for i, enc in enumerate(good):
        assert tc.host_point_from_mont(pts[i].numpy()) == rc.g1_decompress(enc)


def _msm_inputs(K, B, seed):
    rng = np.random.default_rng(seed)
    host_pts = _points(seed, K)
    host_pts[0] = None  # an identity point
    scal = [[int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(K)] for _ in range(B)]
    scal[0][min(1, K - 1)] = 0  # a zero scalar
    scal[1][2] = FR_SPEC.N - 1
    pts = np.stack([_host(host_pts)] * B)
    sc = np.stack([np.stack([FR_SPEC.encode(s) for s in row]) for row in scal])
    return host_pts, scal, pts, sc


def test_msm_plain_matches_jax_msm_and_pallas_kernel():
    K, B = 8, 4
    host_pts, scal, pts, sc = _msm_inputs(K, B, 21)
    got = cuda_curve.msm(torch.from_numpy(pts), torch.from_numpy(sc)).numpy()  # CPU: plain
    jx = np.asarray(jax.jit(jc.msm)(pts.astype(np.uint32), sc.astype(np.uint32)))
    kern = pallas_curve.make_msm_kernel(K, lanes=4, chunk=4, interpret=True, wbits=4)
    pk = np.asarray(kern(pts.astype(np.uint32), sc.astype(np.uint32)))
    for b in range(B):
        expected = None
        for p, s in zip(host_pts, scal[b]):
            expected = rc.g1_add(expected, rc.g1_mul(p, s))
        assert tc.host_point_from_mont(got[b]) == expected
        assert tc.host_point_from_mont(jx[b]) == expected
        assert jc.host_point_from_mont(pk[b]) == expected


def test_to_affine_and_identity():
    pts = _points(5, 2) + [None]
    h = torch.from_numpy(_host(pts))
    x, y, inf = tc.to_affine(h)
    assert inf.tolist() == [False, False, True]
    for i in range(2):
        assert (FP_SPEC.from_mont_int(x[i].numpy()), FP_SPEC.from_mont_int(y[i].numpy())) == pts[i]
    assert tc.is_identity(tc.add(h[2], h[2])).item()
