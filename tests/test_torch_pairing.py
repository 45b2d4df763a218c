"""The port's tower and pairing (plutus_halo2_tpu_torch/ops/tower.py,
ops/pairing.py — the plain version of csrc/pairing.cu) against the JAX
package's ops/tower.py and ops/pairing.py and the refimpl pairing: Fp12
products, inverses, Frobenius and sparse line products limb for limb,
prepare_g2 array for array, and the KZG opening check accept/reject."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.ops import pairing as jpair  # noqa: E402
from plutus_halo2_tpu.ops import tower as jt  # noqa: E402
from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu.refimpl import pairing as rpair  # noqa: E402
from plutus_halo2_tpu.refimpl.field import Q, fr_inv  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_pairing  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops import pairing as tp  # noqa: E402
from plutus_halo2_tpu_torch.ops import tower as tt  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC  # noqa: E402


def _fp12(seed, B=2):
    rng = np.random.default_rng(seed)
    return np.stack([
        tt.fp12_host_to_mont([(int.from_bytes(rng.bytes(48), "big") % FP_SPEC.N,
                               int.from_bytes(rng.bytes(48), "big") % FP_SPEC.N) for _ in range(6)])
        for _ in range(B)
    ])


def _same(port, jax_out):
    return np.array_equal(port.numpy(), np.asarray(jax_out).astype(np.int64))


def test_fp12_ops_match_jax_tower():
    a, b = _fp12(1), _fp12(2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    assert _same(tt.fp12_mul(ta, tb), jax.jit(jt.fp12_mul)(ja, jb))
    assert _same(tt.fp12_inv(ta), jax.jit(jt.fp12_inv)(ja))
    assert _same(tt.fp12_conj(ta), jax.jit(jt.fp12_conj)(ja))
    for k in (1, 2, 3):
        assert _same(tt.fp12_frobenius(ta, k), jax.jit(lambda x, k=k: jt.fp12_frobenius(x, k))(ja)), k
    c0, c2, c3 = ta[:, 0], ta[:, 1], ta[:, 2]
    assert _same(tt.fp12_mul_sparse023(tb, c0, c2, c3),
                 jax.jit(jt.fp12_mul_sparse023)(jb, ja[:, 0], ja[:, 1], ja[:, 2]))
    one = tt.fp12_mul(ta, tt.fp12_inv(ta))
    assert tt.fp12_eq(one, tt.fp12_one((2,), "cpu")).all()


def test_fp2_ops_match_jax_tower():
    a, b = _fp12(3)[:, 0], _fp12(4)[:, 0]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    assert _same(tt.fp2_mul(ta, tb), jax.jit(jt.fp2_mul)(ja, jb))
    assert _same(tt.fp2_sqr(ta), jax.jit(jt.fp2_sqr)(ja))
    assert _same(tt.fp2_inv(ta), jax.jit(jt.fp2_inv)(ja))
    assert _same(tt.fp2_conj(ta), jax.jit(jt.fp2_conj)(ja))


def test_gammas_and_prepare_g2_match_jax():
    for k in (1, 2, 3):
        assert np.array_equal(tt._GAMMAS[k], jt._GAMMAS[k].astype(np.int64))
    s_g2 = rc.g2_mul(rc.G2_GEN, 0x1234567)
    for q in (rc.G2_GEN, s_g2):
        mine, theirs = tp.prepare_g2(q), jpair.prepare_g2(q)
        assert set(mine) == set(theirs)
        for key in theirs:
            assert np.array_equal(mine[key], theirs[key].astype(np.int64)), key


def _kzg_pairs():
    """e(W, [s]G2) e(-(W z + C - y G1), G2) == 1 for a true KZG opening;
    the second pair adds G1 to the right side and must fail."""
    tau = 0xDEADBEEF12345678
    poly = lambda t: (3 * t * t + 2 * t + 7) % Q  # noqa: E731
    z, y = 5, poly(5)
    commitment = rc.g1_mul(rc.G1_GEN, poly(tau))
    witness = rc.g1_mul(rc.G1_GEN, (poly(tau) - y) * fr_inv(tau - z) % Q)
    s_g2 = rc.g2_mul(rc.G2_GEN, tau)
    er = rc.g1_add(rc.g1_add(rc.g1_mul(witness, z), commitment), rc.g1_neg(rc.g1_mul(rc.G1_GEN, y)))
    er_bad = rc.g1_add(er, rc.G1_GEN)
    return witness, [rc.g1_neg(er), rc.g1_neg(er_bad)], s_g2


def test_pairing_check_matches_refimpl():
    """B = 2 with a true and a false pair, plus the identity rule."""
    w, ers, s_g2 = _kzg_pairs()
    want = [rpair.pairing_check([(w, s_g2), (er, rc.G2_GEN)]) for er in ers]
    assert want == [True, False]
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(s_g2), tp.prepare_g2(rc.G2_GEN))
    el = torch.from_numpy(np.stack([tc.host_point_to_mont(w)] * 3))
    er = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in ers + [None]]))
    el[2] = torch.from_numpy(tc.host_point_to_mont(None))  # e(O, .) e(O, .) == 1
    got = cuda_pairing.pairing_check(el, er, pp)  # CPU: plain
    assert got.tolist() == want + [True]


@pytest.mark.slow
def test_pairing_check_matches_jax_pairing():
    w, ers, s_g2 = _kzg_pairs()
    prep1, prep2 = jpair.prepare_g2(s_g2), jpair.prepare_g2(rc.G2_GEN)
    el_x = np.stack([FP_SPEC.to_mont(w[0])] * 2).astype(np.uint32)
    el_y = np.stack([FP_SPEC.to_mont(w[1])] * 2).astype(np.uint32)
    er_x = np.stack([FP_SPEC.to_mont(p[0]) for p in ers]).astype(np.uint32)
    er_y = np.stack([FP_SPEC.to_mont(p[1]) for p in ers]).astype(np.uint32)
    inf = np.zeros(2, dtype=bool)
    check = jax.jit(lambda ax, ay, bx, by, i: jpair.pairing_check(
        [((ax, ay, i), prep1), ((bx, by, i), prep2)]))
    want = np.asarray(check(el_x, el_y, er_x, er_y, inf))
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    got = tp.pairing_check([((t(el_x), t(el_y), torch.from_numpy(inf)), tp.prepare_g2(s_g2)),
                            ((t(er_x), t(er_y), torch.from_numpy(inf)), tp.prepare_g2(rc.G2_GEN))])
    assert got.tolist() == want.tolist() == [True, False]
