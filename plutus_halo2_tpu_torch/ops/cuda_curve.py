"""Curve kernels (``csrc/msm.cu``, ``csrc/decompress.cu``,
``csrc/subgroup.cu``), their plain PyTorch versions and their launch
counters.

``msm`` replaces ``plutus_halo2_tpu/ops/pallas_curve.py:233``
``make_msm_kernel``: B independent MSMs sum_k s_k P_k over K points. Points
are (B, K, 3, 25) projective Montgomery limbs, scalars (B, K, 17) canonical
Fr limbs; the result is a (B, 3, 25) projective point whose representative
may differ from the plain version's, so compare results in affine
coordinates. The plain version is ``ops/curve.msm`` (the JAX package's
``jc.msm``).

``decompress_hinted`` replaces ``make_decompress_kernel`` (``:367``), both
variants: hinted decompression of (B, K, 48) compressed points, and with
weights also the per-row aggregate subgroup test on the decoded points.
``aggregate_subgroup_check`` replaces ``make_subgroup_kernel`` (``:642``):
that test on (B, K, 3, 25) decoded points. Their plain versions are
``ops/curve.decompress(..., y_hint=)`` and
``ops/curve.aggregate_subgroup_check``. Points and valid flags are
bit-identical to the plain version's on every row. The test's verdict
depends only on the points and the weights, but on a row with a point off
the curve (an invalid encoding) the complete formulas no longer add points
and the verdict depends on the summation order: compare sub_ok on rows
whose points are all valid, and valid & sub_ok everywhere."""

from __future__ import annotations

import torch

from . import _build, curve
from .limb import FP_SPEC, FR_SPEC

MAX_K = 128  # points per row the row-layout kernels take


def msm_plain(points, scalars):
    return curve.msm(points, scalars)


def _check_k(K: int, name: str):
    if K < 1 or K > MAX_K:
        raise ValueError(f"{name} kernel takes 1 <= K <= {MAX_K} points per row, got {K}")


def msm(points, scalars):
    if points.device.type == "cpu":
        return msm_plain(points, scalars)
    _build.require(points, "points", torch.int64, (None, None, 3, FP_SPEC.L))
    B, K = points.shape[:2]
    _build.require(scalars, "scalars", torch.int64, (B, K, FR_SPEC.L))
    _check_k(K, "msm")
    out = torch.empty((B, 3, FP_SPEC.L), dtype=torch.int64, device=points.device)
    lib = _build.library()
    _build.check(lib.ph2_msm(_build.ptr(points), _build.ptr(scalars), _build.ptr(out), B, K,
                             _build.stream_ptr()), "ph2_msm")
    msm.launches += 1
    return out


msm.launches = 0


def _weights_on(weights, K: int, device) -> torch.Tensor:
    """Checked (rounds, K) weights as a contiguous int32 tensor on `device`."""
    return curve.check_weights(weights, K).to(torch.int32).to(device).contiguous()


def decompress_hinted_plain(pt_raw, y_hints, weights=None):
    pts, valid = curve.decompress(pt_raw, y_hint=y_hints)
    if weights is None:
        return pts, valid
    return pts, valid, curve.aggregate_subgroup_check(pts, weights)


def decompress_hinted(pt_raw, y_hints, weights=None):
    """pt_raw (B, K, 48) uint8, y_hints (B, K, 25) limbs -> (points
    (B, K, 3, 25), valid (B, K) bool), and with weights (rounds, K) also
    sub_ok (B,) bool."""
    if pt_raw.device.type == "cpu":
        return decompress_hinted_plain(pt_raw, y_hints, weights)
    _build.require(pt_raw, "pt_raw", torch.uint8, (None, None, 48))
    B, K = pt_raw.shape[:2]
    _build.require(y_hints, "y_hints", torch.int64, (B, K, FP_SPEC.L))
    _check_k(K, "decompress")
    dev = pt_raw.device
    pts = torch.empty((B, K, 3, FP_SPEC.L), dtype=torch.int64, device=dev)
    valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    w = sub_ok = None
    if weights is not None:
        w = _weights_on(weights, K, dev)
        sub_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = _build.library()
    _build.check(lib.ph2_decompress(
        _build.ptr(pt_raw), _build.ptr(y_hints), _build.ptr(w) if w is not None else None,
        _build.ptr(pts), _build.ptr(valid), _build.ptr(sub_ok) if sub_ok is not None else None,
        B, K, 0 if w is None else w.shape[0], _build.BLOCK_THREADS, _build.stream_ptr()),
        "ph2_decompress")
    decompress_hinted.launches += 1
    return (pts, valid) if w is None else (pts, valid, sub_ok)


decompress_hinted.launches = 0


def aggregate_subgroup_check_plain(points, weights):
    return curve.aggregate_subgroup_check(points, weights)


def aggregate_subgroup_check(points, weights):
    """points (B, K, 3, 25) projective Montgomery, weights (rounds, K) in
    [1, 2^16) -> (B,) bool."""
    if points.device.type == "cpu":
        return aggregate_subgroup_check_plain(points, weights)
    _build.require(points, "points", torch.int64, (None, None, 3, FP_SPEC.L))
    B, K = points.shape[:2]
    _check_k(K, "subgroup")
    w = _weights_on(weights, K, points.device)
    ok = torch.empty((B,), dtype=torch.bool, device=points.device)
    lib = _build.library()
    _build.check(lib.ph2_subgroup(_build.ptr(points), _build.ptr(w), _build.ptr(ok), B, K,
                                  w.shape[0], _build.BLOCK_THREADS, _build.stream_ptr()),
                 "ph2_subgroup")
    aggregate_subgroup_check.launches += 1
    return ok


aggregate_subgroup_check.launches = 0
