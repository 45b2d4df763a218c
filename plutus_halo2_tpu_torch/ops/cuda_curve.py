"""MSM kernel (``csrc/msm.cu``), its plain PyTorch version and its launch
counter.

Replaces ``plutus_halo2_tpu/ops/pallas_curve.py:233`` ``make_msm_kernel``:
B independent MSMs sum_k s_k P_k over K points. Points are (B, K, 3, 25)
projective Montgomery limbs, scalars (B, K, 17) canonical Fr limbs; the
result is a (B, 3, 25) projective point whose representative may differ
from the plain version's, so compare results in affine coordinates. The
plain version is ``ops/curve.msm`` (the JAX package's ``jc.msm``)."""

from __future__ import annotations

import torch

from . import _build, curve
from .limb import FP_SPEC, FR_SPEC


def msm_plain(points, scalars):
    return curve.msm(points, scalars)


def msm(points, scalars):
    if points.device.type == "cpu":
        return msm_plain(points, scalars)
    _build.require(points, "points", torch.int64, (None, None, 3, FP_SPEC.L))
    B, K = points.shape[:2]
    _build.require(scalars, "scalars", torch.int64, (B, K, FR_SPEC.L))
    if K < 1 or K > 128:
        raise ValueError(f"msm kernel takes 1 <= K <= 128 points per row, got {K}")
    out = torch.empty((B, 3, FP_SPEC.L), dtype=torch.int64, device=points.device)
    lib = _build.library()
    _build.check(lib.ph2_msm(_build.ptr(points), _build.ptr(scalars), _build.ptr(out), B, K,
                             _build.stream_ptr()), "ph2_msm")
    msm.launches += 1
    return out


msm.launches = 0
