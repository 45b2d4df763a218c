"""Field kernels: the static-exponent pow ladder (``csrc/pow.cu``) and the
elementwise Montgomery-product test kernel (``csrc/field_test.cu``), with
their plain PyTorch versions and launch counters.

The pow kernel replaces ``plutus_halo2_tpu/ops/pallas_field.py:32``
``make_pow_kernel``. On the verifier's path it runs as the Fr inversion at
the root of the pooled batch inversion (exponent q - 2, width 1) and as the
Fp square-root ladder of hintless decompression (exponent (p + 1) / 4,
one element per proof point).

The pow kernel gives each element a group of lanes that share each product
of its ladder (``csrc/lanes.cuh``: CIOS with the multiplier's words
broadcast by shuffles and the carries resolved once a product by a
carry-lookahead over the group); its launcher fixes the lanes and the
elements a block for both fields (``POW_LANES``, ``POW_ROWS`` in
``csrc/pow.cu``), as the test kernel's fixes its threads a block
(``MONT_MUL_THREADS``, ``csrc/field_test.cu``).

Each wrapper takes the port's int64 16-bit-limb Montgomery tensors. A CPU
tensor goes to the plain version; a CUDA tensor goes to the kernel, or the
wrapper raises."""

from __future__ import annotations

import torch

from . import _build
from .limb import FP_SPEC, FR_SPEC, FieldSpec, mont_mul, mont_pow_static, window_digits


def pow_plain(x, spec: FieldSpec, exponent: int):
    """The plain version: ``limb.mont_pow_static`` (same 4-bit window)."""
    return mont_pow_static(spec, x, exponent)


def mont_mul_plain(a, b, spec: FieldSpec):
    return mont_mul(spec, a, b)


_DIGITS: dict = {}


def _digits(exponent: int, device) -> torch.Tensor:
    key = (exponent, str(device))
    d = _DIGITS.get(key)
    if d is None:
        d = torch.tensor(window_digits(exponent), dtype=torch.int32, device=device)
        _DIGITS[key] = d
    return d


def _pow(fn: str, spec: FieldSpec, x, exponent: int):
    _build.require(x, "x", torch.int64, (*x.shape[:-1], spec.L))
    out = torch.empty_like(x)
    d = _digits(exponent, x.device)
    n = x.numel() // spec.L
    lib = _build.library()
    _build.check(getattr(lib, fn)(_build.ptr(x), _build.ptr(out), n, _build.ptr(d), d.numel(),
                                  _build.stream_ptr()), fn)
    return out


def fr_pow(x, exponent: int):
    """x^exponent over Fr for (..., 17) Montgomery limbs."""
    if x.device.type == "cpu":
        return pow_plain(x, FR_SPEC, exponent)
    out = _pow("ph2_pow_fr", FR_SPEC, x, exponent)
    fr_pow.launches += 1
    return out


fr_pow.launches = 0


def fp_pow(x, exponent: int):
    """x^exponent over Fp for (..., 25) Montgomery limbs."""
    if x.device.type == "cpu":
        return pow_plain(x, FP_SPEC, exponent)
    out = _pow("ph2_pow_fp", FP_SPEC, x, exponent)
    fp_pow.launches += 1
    return out


fp_pow.launches = 0


def _mont_mul(fn: str, spec: FieldSpec, a, b):
    _build.require(a, "a", torch.int64, (*a.shape[:-1], spec.L))
    _build.require(b, "b", torch.int64, tuple(a.shape))
    out = torch.empty_like(a)
    lib = _build.library()
    _build.check(getattr(lib, fn)(_build.ptr(a), _build.ptr(b), _build.ptr(out),
                                  a.numel() // spec.L, _build.stream_ptr()), fn)
    return out


def fp_mont_mul(a, b):
    """Elementwise Fp Montgomery product through the device field library."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, FP_SPEC)
    out = _mont_mul("ph2_mont_mul_fp", FP_SPEC, a, b)
    fp_mont_mul.launches += 1
    return out


fp_mont_mul.launches = 0


def fr_mont_mul(a, b):
    """Elementwise Fr Montgomery product through the device field library."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, FR_SPEC)
    out = _mont_mul("ph2_mont_mul_fr", FR_SPEC, a, b)
    fr_mont_mul.launches += 1
    return out


fr_mont_mul.launches = 0
