"""The port's subgroup arithmetic (plutus_halo2_tpu_torch/ops/curve.py)
against the JAX package's ops/curve.py: projective equality, the exact
per-point subgroup test, and the aggregate test — the plain version of
csrc/subgroup.cu and of the fused csrc/decompress.cu — verdict for verdict
with the same weights on the crafted rows of test_jax_verifier.py:243-265
(honest rows with the identity, an all-identity row, one and two
non-subgroup points) at 1 and 2 rounds; plus the weight drawing and
checking. The JAX package's aggregate test runs its MSM scan eagerly (about
a minute on the CPU), so its comparison is marked slow; the tier-1 cases
hold the port to the rows' construction and to jc.subgroup_check."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.ops import curve as jc  # noqa: E402
from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu.refimpl.field import P  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC  # noqa: E402


def _nonsubgroup_point():
    """A valid E(Fp) point with nonzero h-torsion (outside G1)."""
    x = 100
    while True:
        rhs = (x**3 + 4) % P
        y = pow(rhs, (P + 1) >> 2, P)
        if y * y % P == rhs and not rc.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


EVIL = _nonsubgroup_point()
G = [rc.g1_mul(rc.G1_GEN, 3 + i) for i in range(3)]
ROWS = [
    [G[0], G[1], G[2], None],       # honest, with identity
    [G[0], EVIL, G[2], G[1]],       # non-subgroup member
    [None, None, None, None],       # all-identity row
    [EVIL, EVIL, G[1], G[0]],       # two bad points
]


def _host(pts):
    return np.stack([tc.host_point_to_mont(p) for p in pts])


@pytest.fixture(scope="module")
def rows():
    return np.stack([_host(row) for row in ROWS])


def _scaled(h, s):
    """The same projective point with (X, Y, Z) scaled by s (s != 0)."""
    sm = torch.from_numpy(FP_SPEC.to_mont(s))
    return torch.stack([tc.fp.mul(torch.from_numpy(h[i]), sm) for i in range(3)])


def test_eq_matches_jax_across_representatives():
    a, b = _host([G[0], G[1], None]), _host([G[0], G[0], None])
    p = torch.stack([_scaled(a[0], 7), _scaled(a[1], 5), torch.from_numpy(a[2]),
                     torch.from_numpy(a[0])])
    q = torch.stack([torch.from_numpy(b[0]), torch.from_numpy(b[1]), _scaled(b[2], 3),
                     torch.from_numpy(b[2])])
    got = tc.eq(p, q)
    want = np.asarray(jax.jit(jc.eq)(p.numpy().astype(np.uint32), q.numpy().astype(np.uint32)))
    assert got.tolist() == want.tolist() == [True, False, True, False]


def test_subgroup_check_matches_jax(rows):
    pts = rows.reshape(-1, 3, FP_SPEC.L)
    got = tc.subgroup_check(torch.from_numpy(pts))
    want = np.asarray(jax.jit(jc.subgroup_check)(pts.astype(np.uint32)))
    assert got.tolist() == want.tolist()
    assert got.tolist() == [p is not EVIL for row in ROWS for p in row]


@pytest.mark.parametrize("rounds", [1, 2])
def test_aggregate_subgroup_check_rows(rows, rounds):
    w = jc.subgroup_weights(4, rounds=rounds, rng=np.random.default_rng(11))
    got = tc.aggregate_subgroup_check(torch.from_numpy(rows), w)
    assert got.tolist() == [True, False, True, False]
    # the CPU wrapper of the subgroup kernel is its plain version
    assert cuda_curve.aggregate_subgroup_check(torch.from_numpy(rows), w).tolist() == got.tolist()


@pytest.mark.slow
@pytest.mark.parametrize("rounds", [1, 2])
def test_aggregate_subgroup_check_matches_jax(rows, rounds):
    w = jc.subgroup_weights(4, rounds=rounds, rng=np.random.default_rng(11))
    got = tc.aggregate_subgroup_check(torch.from_numpy(rows), w)
    want = np.asarray(jc.aggregate_subgroup_check(rows.astype(np.uint32), w))
    assert got.tolist() == want.tolist()


def test_short_window_msm_is_limb_identical():
    """The aggregate's MSM runs 4 windows (the weights are below 2^16); the
    skipped all-zero windows leave the identity exact, so the limbs equal
    the full 64-window MSM's (the JAX package's jc.msm computes the latter)."""
    pts = torch.from_numpy(_host([G[0], EVIL, None, G[2]])[None].repeat(2, 0))
    limbs = torch.zeros((2, 4, FR_SPEC.L), dtype=torch.int64)
    limbs[..., 0] = torch.tensor([[1, 65535, 7, 4096], [2, 3, 60000, 1]])
    assert torch.equal(tc.msm(pts, limbs, nwin=4), tc.msm(pts, limbs))


def test_subgroup_weights_drawn_and_checked():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = tc.subgroup_weights(10, 3, g1), tc.subgroup_weights(10, 3, g2)
    assert torch.equal(a, b) and a.shape == (3, 10) and a.dtype == torch.int64
    fresh = tc.subgroup_weights(10, 2)
    for w in (a, fresh):
        assert bool(((w >= 1) & (w < 1 << tc.SUBGROUP_WEIGHT_BITS)).all())
    assert tc.DEFAULT_SUBGROUP_ROUNDS == jc.DEFAULT_SUBGROUP_ROUNDS
    assert tc.SUBGROUP_WEIGHT_BITS == jc.SUBGROUP_WEIGHT_BITS
    assert tc.BETA == jc._derive_beta()
    assert np.array_equal(tc._BETA_MONT, np.asarray(jc._BETA_MONT).astype(np.int64))
    for bad in (np.zeros((1, 10), np.int64), np.full((1, 10), 1 << 16), np.ones((1, 9), np.int64),
                np.ones(10, np.int64), np.full((1, 10), 0.5)):
        with pytest.raises(ValueError):
            tc.check_weights(bad, 10)
