"""The port's 16-bit-limb field arithmetic (plutus_halo2_tpu_torch/ops/limb.py)
against the JAX package's ops/limb.py and against Python integers: the same
random inputs (numpy seeds) go to both sides and every result must match
limb for limb — exact finite-field arithmetic, no tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.ops import limb as jlimb  # noqa: E402
from plutus_halo2_tpu_torch.ops import limb  # noqa: E402

FIELDS = {
    "fp": (limb.fp, limb.FP_SPEC, jlimb.fp),
    "fr": (limb.fr, limb.FR_SPEC, jlimb.fr),
}


def _rand_mont(spec, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N for _ in range(n)]
    vals[:3] = [0, 1, spec.N - 1]  # edge values
    return vals, np.stack([spec.to_mont(v) for v in vals])


def _eq(port, jax_out):
    return np.array_equal(port.numpy(), np.asarray(jax_out).astype(np.int64))


def test_spec_constants_match_jax():
    for spec, jspec in ((limb.FP_SPEC, jlimb.FP_SPEC), (limb.FR_SPEC, jlimb.FR_SPEC)):
        assert (spec.N, spec.L, spec.R_mod, spec.R2_mod, spec.N_inv_neg) == (
            jspec.N, jspec.L, jspec.R_mod, jspec.R2_mod, jspec.N_inv_neg)
        assert np.array_equal(spec.one_mont, jspec.one_mont.astype(np.int64))
        assert np.array_equal(spec.nprime_limbs, jspec.nprime_limbs.astype(np.int64))


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_ring_ops_match_jax(name):
    f, spec, jf = FIELDS[name]
    va, a = _rand_mont(spec, 16, 1)
    vb, b = _rand_mont(spec, 16, 2)
    b[5], vb[5] = a[5], va[5]  # a == b: sub gives 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    for op in ("add", "sub", "mul"):
        got = getattr(f, op)(ta, tb)
        assert _eq(got, jax.jit(getattr(jf, op))(ja, jb)), op
    assert _eq(f.neg(ta), jax.jit(jf.neg)(ja))
    assert _eq(f.sqr(ta), jax.jit(jf.sqr)(ja))
    # and against Python integers
    prod = f.mul(ta, tb)
    for i in range(16):
        assert spec.from_mont_int(prod[i].numpy()) == va[i] * vb[i] % spec.N
        assert limb.limbs_to_int(prod[i].numpy()) < spec.N


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_mont_conversions_and_pow_match_jax(name):
    f, spec, jf = FIELDS[name]
    vals, a = _rand_mont(spec, 8, 3)
    canon = np.stack([spec.encode(v) for v in vals])
    assert _eq(f.to_mont(torch.from_numpy(canon)), jax.jit(jf.to_mont)(canon.astype(np.uint32)))
    back = f.from_mont(torch.from_numpy(a))
    assert np.array_equal(back.numpy(), canon)
    for e in (0, 1, 5, 65537):
        got = f.pow(torch.from_numpy(a), e)
        assert _eq(got, jax.jit(lambda x, e=e: jf.pow(x, e))(a.astype(np.uint32))), e


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_lazy_sums_match_jax(name):
    f, spec, jf = FIELDS[name]
    _va, a = _rand_mont(spec, 24, 4)
    _vb, b = _rand_mont(spec, 24, 5)
    a3, b3 = a.reshape(4, 6, spec.L), b.reshape(4, 6, spec.L)
    got = f.dot_lazy(torch.from_numpy(a3), torch.from_numpy(b3), dim=-2)
    assert _eq(got, jax.jit(lambda x, y: jf.dot_lazy(x, y, axis=-2))(a3.astype(np.uint32), b3.astype(np.uint32)))
    got = f.sum_lazy(torch.from_numpy(a3), dim=-2)
    assert _eq(got, jax.jit(lambda x: jf.sum_lazy(x, axis=-2))(a3.astype(np.uint32)))


@pytest.mark.parametrize("with_hook", [False, True])
def test_batch_inv_matches_jax(with_hook):
    f, spec, jf = FIELDS["fr"]
    vals, a = _rand_mont(spec, 12, 6)
    a[0] = spec.to_mont(7)  # no zeros: every element has an inverse
    a3 = a.reshape(2, 6, spec.L)
    hook_t = (lambda t: f.pow(t, spec.N - 2)) if with_hook else None
    hook_j = (lambda t: jf.pow(t, spec.N - 2)) if with_hook else None
    got = f.batch_inv(torch.from_numpy(a3), dim=-2, inv_fn=hook_t)
    want = jax.jit(lambda x: jf.batch_inv(x, axis=-2, inv_fn=hook_j))(a3.astype(np.uint32))
    assert _eq(got, want)
    one = f.mul(got, torch.from_numpy(a3))
    assert (one == torch.from_numpy(spec.one_mont)).all()


def test_predicates_and_select():
    f, spec, _jf = FIELDS["fp"]
    _v, a = _rand_mont(spec, 4, 7)
    ta = torch.from_numpy(a)
    assert f.is_zero(ta).tolist() == [True, False, False, False]
    assert f.eq(ta, ta.clone()).all()
    assert not f.eq(ta, f.add(ta, f.one((4,), "cpu"))).any()
    sel = limb.select(torch.tensor([True, False, True, False]), ta, torch.zeros_like(ta))
    assert torch.equal(sel[0::2], ta[0::2]) and (sel[1::2] == 0).all()


def test_normalize_carry_chains():
    """Long propagate chains (0xFFFF runs) must resolve exactly."""
    cols = torch.tensor([[0x10000] + [0xFFFF] * 10 + [0], [0x1FFFF, 0xFFFF, 0xFFFF, 0, 5, 0, 0, 0, 0, 0, 0, 0]])
    out = limb.normalize(cols, 18)
    for r in range(2):
        want = sum(int(c) << (16 * i) for i, c in enumerate(cols[r].tolist())) % (1 << (16 * 12))
        assert limb.limbs_to_int(out[r].numpy()) == want
        assert (out[r] <= 0xFFFF).all()
