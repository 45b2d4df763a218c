"""The plain version of the MSM kernel's decomposition (ops/curve.msm_windowed)
against the Pallas MSM kernel (plutus_halo2_tpu/ops/pallas_curve.py
make_msm_kernel, in interpret mode) and the reference implementation, in
affine coordinates: K = 9 in chunks of 4 (two whole, one ragged) at the
verifier's 5-bit windows, K = 3 in one padded chunk at the stage probe's
4-bit windows, with an identity point, a zero scalar, q - 1 and 1 among
the inputs (test_torch_curve.py holds K = 8 at 4 bits against the
per-point MSM). Each case compiles the kernel in interpret mode for ~40 s
on a CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the Pallas kernel runs on JAX's CPU backend)

from plutus_halo2_tpu.ops import curve as jc  # noqa: E402
from plutus_halo2_tpu.ops import pallas_curve  # noqa: E402
from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FR_SPEC  # noqa: E402

B = 4  # a multiple of the kernel's lanes


@pytest.mark.parametrize("K,wbits", [(9, 5), (3, 4)])
def test_msm_windowed_matches_pallas_kernel(K, wbits):
    rng = np.random.default_rng(7 * K + wbits)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=K)]
    host[0] = None
    scal = [[int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(K)] for _ in range(B)]
    scal[0][K - 1] = 0
    scal[1][K // 2] = FR_SPEC.N - 1
    scal[2][0] = 1
    pts = np.stack([np.stack([tc.host_point_to_mont(p) for p in host])] * B)
    sc = np.stack([np.stack([FR_SPEC.encode(s) for s in row]) for row in scal])
    kern = pallas_curve.make_msm_kernel(K, lanes=4, chunk=4, interpret=True, wbits=wbits)
    pk = np.asarray(kern(pts.astype(np.uint32), sc.astype(np.uint32)))
    got = tc.msm_windowed(torch.from_numpy(pts), torch.from_numpy(sc), wbits)
    want = [rc.g1_msm(row, host) for row in scal]
    assert [tc.host_point_from_mont(g.numpy()) for g in got] == want
    assert [jc.host_point_from_mont(p) for p in pk] == want
