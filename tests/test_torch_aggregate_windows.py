"""The plain version of the fused decompress kernel's aggregate subgroup test
(ops/curve.aggregate_subgroup_check_windowed: the weights' signed 3-bit
windows over the tables [1P..4P], the window sums over a row's points, one
chain of 3 doublings a window, then the endomorphism test of each
aggregate) against the per-point aggregate test (ops/curve.aggregate_
subgroup_check, which test_torch_subgroup.py holds to the JAX package's
jc.aggregate_subgroup_check) and the rows' construction, at 1 to 3 rounds,
on rows with the identity, all identities, and one or two points outside
G1; and the hinted decompression wrapper's CPU path (its plain version) on
decoded rows, sub_ok compared on rows whose points all decode and
valid & sub_ok everywhere. (The Pallas fused kernel,
make_decompress_kernel(K, interpret=True, subgroup_rounds=r), takes ~700 s
to compile in interpret mode on a CPU, so it is not run here.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu.refimpl.field import P  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC  # noqa: E402


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
G = [rc.g1_mul(rc.G1_GEN, 3 + i) for i in range(4)]
ROWS = [
    [G[0], G[1], G[2], None, G[3]],      # honest, with the identity
    [G[0], EVIL, G[2], G[1], G[3]],      # one point outside G1
    [None, None, None, None, None],      # all identities
    [EVIL, EVIL, G[1], G[0], None],      # two points outside G1
    [G[3], G[3], G[3], G[3], G[3]],      # one point five times
]
MEMBER = [True, False, True, False, True]


def _rows():
    return torch.from_numpy(np.stack([np.stack([tc.host_point_to_mont(p) for p in row]) for row in ROWS]))


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_windowed_aggregate_matches_per_point_and_construction(rounds):
    pts = _rows()
    w = tc.subgroup_weights(len(ROWS[0]), rounds, torch.Generator().manual_seed(10 + rounds))
    got = tc.aggregate_subgroup_check_windowed(pts, w)
    assert got.tolist() == tc.aggregate_subgroup_check(pts, w).tolist() == MEMBER


def test_windowed_aggregate_is_the_weighted_sum():
    """The window part alone: the chain over the window sums is sum_k w_k P_k
    for weights with every digit pattern (1, 2^16 - 1, carries)."""
    pts = _rows()[:1]
    weights = [1, 0xFFFF, 0x4924, 0x7FFF, 12345]
    dig = tc.signed_recode((torch.tensor(weights)[:, None] >> (3 * torch.arange(6))) & 7, 4)
    assert [sum(d << (3 * i) for i, d in enumerate(row)) for row in dig.tolist()] == weights
    wsum = tc.window_sums(tc.multiples_table(pts, 4), dig[None])
    q = tc.window_chain(wsum, 3)
    want = None
    for p, wk in zip(ROWS[0], weights):
        want = rc.g1_add(want, rc.g1_mul(p, wk))
    assert tc.host_point_from_mont(q[0].numpy()) == want


def test_decompress_plain_path_uses_the_windowed_test():
    """cuda_curve.decompress_hinted on CPU tensors (its plain version):
    points and flags as decompress(..., y_hint=), sub_ok as the per-point
    test on rows that decode, valid & sub_ok everywhere."""
    rows = [ROWS[0], ROWS[1], ROWS[4]]
    raw = np.stack([np.stack([np.frombuffer(rc.g1_compress(p), np.uint8) for p in row]) for row in rows])
    hints = np.stack([np.stack([FP_SPEC.encode(p[1] if p is not None else 0) for p in row]) for row in rows])
    raw[2, 1, 47] ^= 1  # x changes: not on the curve with that hint
    w = tc.subgroup_weights(5, 2, torch.Generator().manual_seed(4))
    pts, valid, sub_ok = cuda_curve.decompress_hinted(torch.from_numpy(raw), torch.from_numpy(hints), w)
    p0, v0 = tc.decompress(torch.from_numpy(raw), y_hint=torch.from_numpy(hints))
    assert torch.equal(pts, p0) and torch.equal(valid, v0)
    ok_rows = valid.all(-1)
    assert ok_rows.tolist() == [True, True, False]
    per_point = tc.aggregate_subgroup_check(pts, w)
    assert torch.equal(sub_ok[ok_rows], per_point[ok_rows])
    assert torch.equal(sub_ok & ok_rows, per_point & ok_rows)
    assert sub_ok[ok_rows].tolist() == [True, False]
