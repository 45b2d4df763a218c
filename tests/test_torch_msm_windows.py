"""The plain version of the MSM kernel's decomposition (ops/curve.msm_windowed:
signed windows, a table of multiples per point, window sums over the row's
points, one doubling chain per row) against the per-point plain MSM
(ops/curve.msm, the JAX package's jc.msm) and the reference implementation,
in affine coordinates, at both window widths; the signed digits against the
scalar they recode; the table of multiples and the doubling chain.
test_torch_msm_pallas.py holds it against the Pallas MSM kernel."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FR_SPEC  # noqa: E402

B = 4


def msm_inputs(K, seed):
    """(host points, scalars, points (B, K, 3, 25), scalar limbs (B, K, 17)):
    random G1 points with the identity at point 0, random scalars with a
    zero, a q - 1 and a 1 among them."""
    rng = np.random.default_rng(seed)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=K)]
    host[0] = None
    scal = [[int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(K)] for _ in range(B)]
    scal[0][K - 1] = 0
    scal[1][K // 2] = FR_SPEC.N - 1
    scal[2][0] = 1
    pts = np.stack([np.stack([tc.host_point_to_mont(p) for p in host])] * B)
    sc = np.stack([np.stack([FR_SPEC.encode(s) for s in row]) for row in scal])
    return host, scal, pts, sc


def affine(arr):
    return [tc.host_point_from_mont(np.asarray(a)) for a in arr]


@pytest.mark.parametrize("wbits", [4, 5])
@pytest.mark.parametrize("K", [1, 3, 8, 9])
def test_msm_windowed_matches_reference(K, wbits):
    host, scal, pts, sc = msm_inputs(K, 10 * K + wbits)
    got = tc.msm_windowed(torch.from_numpy(pts), torch.from_numpy(sc), wbits)
    assert affine(got) == [rc.g1_msm(row, host) for row in scal]


@pytest.mark.parametrize("wbits", [4, 5])
def test_msm_windowed_matches_per_point_msm(wbits):
    """The JAX package's jc.msm's counterpart (its own tests hold the two
    limb for limb) in affine coordinates; the wrapper's CPU path runs the
    latter, whatever the window width."""
    _host, _scal, pts, sc = msm_inputs(9, 3 + wbits)
    pts_t, sc_t = torch.from_numpy(pts), torch.from_numpy(sc)
    got = tc.msm_windowed(pts_t, sc_t, wbits)
    per_point = tc.msm(pts_t, sc_t)
    assert affine(got) == affine(per_point)
    assert torch.equal(cuda_curve.msm(pts_t, sc_t, wbits=wbits), per_point)


@pytest.mark.parametrize("wbits", [4, 5])
def test_scalar_digits_recode_the_scalar(wbits):
    rng = np.random.default_rng(wbits)
    vals = [0, 1, FR_SPEC.N - 1, (1 << 254) + 17] + [
        int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(12)]
    d = tc.scalar_digits(torch.from_numpy(np.stack([FR_SPEC.encode(v) for v in vals])), wbits)
    half = 1 << (wbits - 1)
    assert d.shape == (len(vals), tc.MSM_NWIN[wbits])
    assert int(d.abs().max()) <= half
    for v, row in zip(vals, d.tolist()):
        assert sum(x << (wbits * i) for i, x in enumerate(row)) == v


def test_multiples_table_and_window_chain():
    """Entry e of the table is e P; the chain sums 2^(wbits w) wsum[w]."""
    host = [rc.g1_mul(rc.G1_GEN, 11), None]
    pts = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in host]))
    tab = tc.multiples_table(pts, 16)
    for i, p in enumerate(host):
        assert [tc.host_point_from_mont(tab[i, e].numpy()) for e in range(16)] == [rc.g1_mul(p, e + 1)
                                                                                   for e in range(16)]
    ws = [rc.g1_mul(rc.G1_GEN, k) for k in (3, 0, 5)]
    wsum = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in ws]))
    got = tc.host_point_from_mont(tc.window_chain(wsum, 5).numpy())
    assert got == rc.g1_mul(rc.G1_GEN, 3 + (5 << 10))
