"""The plain version of the pow kernel (ops/cuda_field.fr_pow / fp_pow on CPU
tensors: the 4-bit fixed-window ladder of csrc/pow.cu in PyTorch) against
the JAX package's Pallas pow kernel in interpret mode and Python's pow, at
the verifier's two uses: the Fr inversion root (q - 2, width 1) and the Fp
square-root ladder ((p + 1) / 4). Compared on canonical values, since the
Pallas Fp kernel works in its own 24-limb domain."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.ops import limb as jlimb  # noqa: E402
from plutus_halo2_tpu.ops.pallas_core import FP24_SPEC  # noqa: E402
from plutus_halo2_tpu.ops.pallas_field import make_pow_kernel  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_field  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC, window_digits  # noqa: E402


@pytest.mark.parametrize("field", ["fr_inverse", "fp_sqrt"])
def test_pow_matches_pallas_kernel(field):
    rng = random.Random(15)
    B = 8
    if field == "fr_inverse":
        spec, kspec, e, width, fn = FR_SPEC, jlimb.FR_SPEC, FR_SPEC.N - 2, 1, cuda_field.fr_pow
    else:
        spec, kspec, e, width, fn = FP_SPEC, FP24_SPEC, (FP_SPEC.N + 1) >> 2, 3, cuda_field.fp_pow
    vals = [[rng.randrange(1, spec.N) for _ in range(width)] for _ in range(B)]
    vals[0][0] = 0
    x = np.stack([np.stack([spec.to_mont(v) for v in row]) for row in vals])
    got = fn(torch.from_numpy(x), e).numpy()
    xk = np.stack([np.stack([kspec.to_mont(v) for v in row]) for row in vals])
    kern = make_pow_kernel(kspec, e, width, lanes=B, interpret=True)
    want = np.asarray(kern(xk))
    for i in range(B):
        for j in range(width):
            v = spec.from_mont_int(got[i, j])
            assert v == kspec.from_mont_int(want[i, j])
            assert v == pow(vals[i][j], e, spec.N)


def test_window_digits_match_pallas_schedule():
    from plutus_halo2_tpu.ops.pallas_core import window_digits as j_digits

    for e in (FR_SPEC.N - 2, (FP_SPEC.N + 1) >> 2, 12345, 1):
        assert window_digits(e) == j_digits(e)[0].tolist()
