"""The copied counting functions equal chip_smoke.py's on chip_smoke.py's
own kinds of inputs, and a batch's work adds up as stated."""

import random
import sys

import pytest

from portbench import roofline, spec
from portbench.reference.verifier import ACCEPTED, DECODE, EQUATION, Outcome

sys.path.insert(0, str(spec.ROOT))
import chip_smoke  # noqa: E402

BLS_X = 0xD201000000010000


def test_peaks_and_constants():
    for name in ("INT32_OPS_PER_S", "HBM_BYTES_PER_S", "FP2_MUL", "FP12_MUL", "FP12_SQR", "CYC_SQR", "LINE", "FROB",
                 "FP_INV_OPS", "SUB_WBITS", "SUB_NWIN", "Z_LADDERS"):
        assert getattr(roofline, name) == getattr(chip_smoke, name), name


@pytest.mark.parametrize("n_live", [0, 1, 2])
def test_pairing_ops(n_live):
    assert roofline._pairing_ops(n_live, BLS_X) == chip_smoke._pairing_ops(n_live, BLS_X)


@pytest.mark.parametrize("k", [3, 8, 16, 17, 19, 32, 36, 64])
def test_msm_products(k):
    rng = random.Random(k)
    q = roofline.BLS_X and 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
    for bits in (128, 255):
        scalars = [rng.randrange(1 << bits) % q for _ in range(k)]
        scalars[0] = 0
        live = [rng.random() > 0.1 for _ in range(k)]
        assert roofline._msm_fp_products(scalars, live) == chip_smoke._msm_fp_products(scalars, live)
        assert roofline._signed_digits(scalars[1]) == chip_smoke._signed_digits(scalars[1])


@pytest.mark.parametrize("rounds", [1, 2])
def test_aggregate_products(rounds):
    rng = random.Random(rounds)
    for n in (10, 11, 15, 18):
        w = [[rng.randrange(1, 1 << 16) for _ in range(n)] for _ in range(rounds)]
        live = [rng.random() > 0.2 for _ in range(n)]
        assert roofline._aggregate_fp_products(w, live) == chip_smoke._aggregate_fp_products(w, live)
        assert roofline._sub_digits(w[0][0]) == chip_smoke._sub_digits(w[0][0])


@pytest.mark.parametrize("ops,nbytes", [(1e9, 1e6), (1e6, 1e9), (0, 0)])
def test_bound(ops, nbytes):
    assert roofline._bound_ms(ops, nbytes) == chip_smoke._bound_ms(ops, nbytes)


def test_batch_work_adds_up():
    g = (1, 2)
    term = [(5, g), (7, (3, 4))]
    ok = Outcome(ACCEPTED, g, g, [term])
    bad_eq = Outcome(EQUATION, g, g, [term])
    bad_dec = Outcome(DECODE)
    outcomes = [ok, bad_eq, bad_dec]
    pair2 = roofline._pairing_ops(2, BLS_X)
    msm1 = 2 * roofline._msm_fp_products([5, 7], [True, True]) * roofline._cios_products(12)
    rows = [0, 1, 2, 0]
    w = roofline.batch_work("verify", rows, outcomes)
    assert w["pairing"].ops == 3 * pair2 and w["msm"].ops == 3 * msm1
    weights = [[1] + [0] * 16, [3] + [0] * 16, [5] + [0] * 16, [7] + [0] * 16]
    w = roofline.batch_work("verify_rlc_device", rows, outcomes, weights, group=2)
    agg = sum(2 * roofline._msm_fp_products(sc, [True, True]) * roofline._cios_products(12)
              for sc in ([1, 3], [1, 3], [0, 7], [0, 7]))
    # two group checks; the first group holds an equation failure: both of its rows re-checked
    assert w["pairing"].ops == 2 * pair2 + 2 * pair2
    assert w["msm"].ops == 3 * msm1 + agg
