"""Curve kernels (``csrc/msm.cu``, ``csrc/decompress.cu``,
``csrc/sqrt_decode.cu``, ``csrc/subgroup.cu``), their plain PyTorch
versions and their launch counters.

``msm`` replaces ``plutus_halo2_tpu/ops/pallas_curve.py:233``
``make_msm_kernel``: B independent MSMs sum_k s_k P_k over K points. Points
are (B, K, 3, 25) projective Montgomery limbs, scalars (B, K, 17) canonical
Fr limbs, ``wbits`` the signed-window width as the Pallas kernel takes it
(5 on the verifier's path, 4 for the stage probe's ``msmp``); the result is
a (B, 3, 25) projective point. Its plain versions: ``ops/curve.msm_windowed``,
the kernel's decomposition step for step, whose limbs the kernel's equal;
and ``msm_plain``, ``ops/curve.msm`` (the JAX package's ``jc.msm``, the
same limbs), which the wrapper runs on CPU tensors so that the CPU
verifier's limbs stay the JAX package's; it sums in another order, so
compare the kernel with it in affine coordinates.

``decompress_hintless`` (``csrc/sqrt_decode.cu``) decodes (B, K, 48)
compressed points without hints in one launch: flags, x < p, x^3 + 4, the
(p + 1) / 4 ladder of the pow kernel, the root check and the sign. Its
plain version is ``ops/curve.decompress`` without a hint (the same 4-bit
window ladder); points and valid flags are bit-identical on every point.
It replaces the Fp use of ``make_pow_kernel``
(``plutus_halo2_tpu/ops/pallas_field.py:32``) and the decoding the JAX
package runs around it under XLA.

``decompress_hinted`` replaces ``make_decompress_kernel`` (``:367``), both
variants: hinted decompression of (B, K, 48) compressed points, and with
weights also the per-row aggregate subgroup test on the decoded points.
``aggregate_subgroup_check`` replaces ``make_subgroup_kernel`` (``:642``):
that test on (B, K, 3, 25) decoded points. Their plain versions are
``ops/curve.decompress(..., y_hint=)`` with
``ops/curve.aggregate_subgroup_check_windowed`` (both kernels'
decomposition of the test), and ``ops/curve.aggregate_subgroup_check``
(the JAX package's algorithm: ``aggregate_subgroup_check_plain``, which
the wrapper runs on CPU tensors, so that the CPU verifier's verdicts stay
the JAX package's). Points and valid flags are bit-identical to the plain
version's on every row. The test's verdict
depends only on the points and the weights, but on a row with a point off
the curve (an invalid encoding) the complete formulas no longer add points
and the verdict depends on the summation order: compare sub_ok on rows
whose points are all valid, and valid & sub_ok everywhere.

The MSM, the fused decompress kernel and the subgroup kernel give each
row a group of lanes and put the fewest rows in a block that fill the SMs
once (``csrc/group.cuh`` group_rows); each launcher fixes its kernel's
lanes (``MSM_LANES`` in ``csrc/msm.cu``, ``DECOMPRESS_LANES`` in
``csrc/decompress.cu``, ``SUBGROUP_LANES`` in ``csrc/subgroup.cu``), and
the unfused decompress kernel's threads a block (``DECOMPRESS_THREADS``).
The hintless decompress kernel gives each point a group of lanes, as the
pow kernel does (``SQRT_DECODE_LANES``, ``SQRT_DECODE_ROWS`` points a
block, in ``csrc/sqrt_decode.cu``)."""

from __future__ import annotations

import torch

from . import _build, cuda_field, curve
from .limb import FP_SPEC, FR_SPEC

MAX_K = 128  # points per row the row-layout kernels take


def msm_plain(points, scalars):
    return curve.msm(points, scalars)


def _check_k(K: int, name: str):
    if K < 1 or K > MAX_K:
        raise ValueError(f"{name} kernel takes 1 <= K <= {MAX_K} points per row, got {K}")


MSM_WBITS = (4, 5)  # the Pallas kernel's widths: 64 windows / 9 entries, 52 / 17


def msm(points, scalars, wbits: int = 5, phases=None):
    """points (B, K, 3, 25), scalars (B, K, 17) -> (B, 3, 25). `phases`, a
    (B, 3) int64 CUDA tensor, receives each row's clock64() at the start,
    before the doubling chain and at the end."""
    if wbits not in MSM_WBITS:
        raise ValueError(f"msm takes wbits in {MSM_WBITS}, got {wbits}")
    if points.device.type == "cpu":
        return msm_plain(points, scalars)
    _build.require(points, "points", torch.int64, (None, None, 3, FP_SPEC.L))
    B, K = points.shape[:2]
    _build.require(scalars, "scalars", torch.int64, (B, K, FR_SPEC.L))
    _check_k(K, "msm")
    if phases is not None:
        _build.require(phases, "phases", torch.int64, (B, 3))
    out = torch.empty((B, 3, FP_SPEC.L), dtype=torch.int64, device=points.device)
    lib = _build.library()
    _build.check(lib.ph2_msm(_build.ptr(points), _build.ptr(scalars), _build.ptr(out), _build.ptr_or_none(phases),
                             B, K, wbits, _build.stream_ptr()), "ph2_msm")
    msm.launches += 1
    return out


msm.launches = 0


def _weights_on(weights, K: int, device) -> torch.Tensor:
    """Checked (rounds, K) weights as a contiguous int32 tensor on `device`:
    CheckedWeights as they are (no copy, no host check), any other weights
    checked on the host and copied."""
    if isinstance(weights, curve.CheckedWeights):
        _build.require(weights.w, "weights", torch.int32, (None, K))
        return weights.w
    return curve.check_weights(weights, K).to(torch.int32).to(device).contiguous()


SQRT_EXP = (FP_SPEC.N + 1) >> 2  # the square root's exponent: p = 3 mod 4


def decompress_hintless(pt_raw):
    """pt_raw (B, K, 48) uint8 -> (points (B, K, 3, 25), valid (B, K)
    bool): each point decoded without a hint, its root by the (p + 1) / 4
    ladder."""
    if pt_raw.device.type == "cpu":
        return curve.decompress(pt_raw)
    _build.require(pt_raw, "pt_raw", torch.uint8, (None, None, 48))
    B, K = pt_raw.shape[:2]
    dev = pt_raw.device
    pts = torch.empty((B, K, 3, FP_SPEC.L), dtype=torch.int64, device=dev)
    valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    d = cuda_field._digits(SQRT_EXP, dev)
    lib = _build.library()
    _build.check(lib.ph2_sqrt_decode(_build.ptr(pt_raw), _build.ptr(pts), _build.ptr(valid), B * K,
                                     _build.ptr(d), d.numel(), _build.stream_ptr()), "ph2_sqrt_decode")
    decompress_hintless.launches += 1
    return pts, valid


decompress_hintless.launches = 0


def decompress_hinted_plain(pt_raw, y_hints, weights=None):
    pts, valid = curve.decompress(pt_raw, y_hint=y_hints)
    if weights is None:
        return pts, valid
    return pts, valid, curve.aggregate_subgroup_check_windowed(pts, weights)


def decompress_hinted(pt_raw, y_hints, weights=None, phases=None):
    """pt_raw (B, K, 48) uint8, y_hints (B, K, 25) limbs -> (points
    (B, K, 3, 25), valid (B, K) bool), and with weights (rounds, K) also
    sub_ok (B,) bool. With weights, `phases`, a (B, 4) int64 CUDA tensor,
    receives each row's clock64() at the start, after decoding, after the
    window chain and at the end."""
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
        if phases is not None:
            _build.require(phases, "phases", torch.int64, (B, 4))
    lib = _build.library()
    _build.check(lib.ph2_decompress(
        _build.ptr(pt_raw), _build.ptr(y_hints), _build.ptr_or_none(w),
        _build.ptr(pts), _build.ptr(valid), _build.ptr_or_none(sub_ok),
        _build.ptr_or_none(phases if w is not None else None), B, K, 0 if w is None else w.shape[0],
        _build.stream_ptr()), "ph2_decompress")
    decompress_hinted.launches += 1
    return (pts, valid) if w is None else (pts, valid, sub_ok)


decompress_hinted.launches = 0


def aggregate_subgroup_check_plain(points, weights):
    return curve.aggregate_subgroup_check(points, weights)


def aggregate_subgroup_check(points, weights, phases=None):
    """points (B, K, 3, 25) projective Montgomery, weights (rounds, K) in
    [1, 2^16) -> (B,) bool. `phases`, a (B, 4) int64 CUDA tensor, receives
    each row's clock64() at the start, after the loads, after the window
    chain and at the end."""
    if points.device.type == "cpu":
        return aggregate_subgroup_check_plain(points, weights)
    _build.require(points, "points", torch.int64, (None, None, 3, FP_SPEC.L))
    B, K = points.shape[:2]
    _check_k(K, "subgroup")
    w = _weights_on(weights, K, points.device)
    if phases is not None:
        _build.require(phases, "phases", torch.int64, (B, 4))
    ok = torch.empty((B,), dtype=torch.bool, device=points.device)
    lib = _build.library()
    _build.check(lib.ph2_subgroup(_build.ptr(points), _build.ptr(w), _build.ptr(ok), _build.ptr_or_none(phases),
                                  B, K, w.shape[0], _build.stream_ptr()),
                 "ph2_subgroup")
    aggregate_subgroup_check.launches += 1
    return ok


aggregate_subgroup_check.launches = 0
