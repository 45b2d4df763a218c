"""The prover's Fr polynomial kernels (``csrc/poly.cu``) with their launch
counters: the NTT, the elementwise product, the scale by one scalar and
the powers weighting a_i k^i.

They port the JAX package's host runtime ``plutus_halo2_tpu/native/``
(``ph2_native.cpp`` in C++ through ctypes; no Pallas kernel), which its
``refimpl/poly.py`` gives every array of 128 or more elements; the port's
``refimpl/poly.py`` gives them these wrappers on an explicit device.

Each wrapper takes (n, 8) int32 tensors of canonical words
(``ops/poly.to_words``) and Python-int scalars. A CPU tensor goes to the
plain version in ``ops/poly.py``; a CUDA tensor goes to the kernel, or the
wrapper raises. The scalars' Montgomery constants (k^(2^b) R mod q for the
powers tables, k R mod q for the scale) are computed on the host and
copied to the card with the call; the tables and the NTT's twiddles are
scratch of each call."""

from __future__ import annotations

import numpy as np
import torch

from ..refimpl.field import Q
from . import _build
from .poly import (
    mul_array_plain,
    ntt_plain,
    powers_mul_array_plain,
    scale_array_plain,
    scalar_words,
)

R_K = (1 << 256) % Q  # the kernels' Montgomery R


def _mont(x: int) -> np.ndarray:
    return scalar_words(x * R_K % Q)


def _bit_powers(k: int, nbits: int, device) -> torch.Tensor:
    """(max(nbits, 1), 8): k^(2^b) R mod q for b < nbits."""
    rows, x = [], k % Q
    for _ in range(max(nbits, 1)):
        rows.append(_mont(x))
        x = x * x % Q
    return torch.from_numpy(np.stack(rows)).to(device)


def _split(nbits: int) -> tuple[int, int]:
    slo = (nbits + 1) // 2
    return slo, nbits - slo


def _scratch(n: int, device) -> torch.Tensor:
    return torch.empty((n, 8), dtype=torch.int32, device=device)


def _check_words(a, name="a"):
    _build.require(a, name, torch.int32, (None, 8))


def fr_ntt(a, omega: int):
    """In-order radix-2 NTT a_j -> sum_i a_i omega^(i j) of (n, 8) words,
    n a power of two (up to 2^30)."""
    if a.device.type == "cpu":
        return ntt_plain(a, omega)
    _check_words(a)
    n = a.shape[0]
    lg = n.bit_length() - 1
    if n == 0 or n & (n - 1) or lg > 30:
        raise ValueError(f"fr_ntt: n = {n} is not a power of two up to 2^30")
    out = torch.empty_like(a)
    slo, shi = _split(max(lg - 1, 0))  # twiddle exponents e < n / 2
    bp = _bit_powers(omega, slo + shi, a.device)
    lo, hi, tw = _scratch(1 << slo, a.device), _scratch(1 << shi, a.device), _scratch(max(n // 2, 1), a.device)
    lib = _build.library()
    _build.check(lib.ph2_fr_ntt(_build.ptr(a), _build.ptr(out), n, lg, _build.ptr(bp), slo, shi, _build.ptr(lo),
                                _build.ptr(hi), _build.ptr(tw), _build.stream_ptr()), "ph2_fr_ntt")
    fr_ntt.launches += 1
    return out


fr_ntt.launches = 0


def fr_mul_array(a, b):
    """a_i b_i."""
    if a.device.type == "cpu":
        return mul_array_plain(a, b)
    _check_words(a)
    _build.require(b, "b", torch.int32, tuple(a.shape))
    out = torch.empty_like(a)
    lib = _build.library()
    _build.check(lib.ph2_fr_mul_array(_build.ptr(a), _build.ptr(b), _build.ptr(out), a.shape[0],
                                      _build.stream_ptr()), "ph2_fr_mul_array")
    fr_mul_array.launches += 1
    return out


fr_mul_array.launches = 0


def fr_scale_array(a, k: int):
    """a_i k."""
    if a.device.type == "cpu":
        return scale_array_plain(a, k)
    _check_words(a)
    out = torch.empty_like(a)
    km = torch.from_numpy(_mont(k)).to(a.device)
    lib = _build.library()
    _build.check(lib.ph2_fr_scale_array(_build.ptr(a), _build.ptr(km), _build.ptr(out), a.shape[0],
                                        _build.stream_ptr()), "ph2_fr_scale_array")
    fr_scale_array.launches += 1
    return out


fr_scale_array.launches = 0


def fr_powers_mul_array(a, k: int):
    """a_i k^i (the coset weighting of coset_evaluate / coset_interpolate)."""
    if a.device.type == "cpu":
        return powers_mul_array_plain(a, k)
    _check_words(a)
    n = a.shape[0]
    out = torch.empty_like(a)
    slo, shi = _split(max(n - 1, 0).bit_length())  # exponents e < n
    bp = _bit_powers(k, slo + shi, a.device)
    lo, hi = _scratch(1 << slo, a.device), _scratch(1 << shi, a.device)
    lib = _build.library()
    _build.check(lib.ph2_fr_powers_mul_array(_build.ptr(a), _build.ptr(out), n, _build.ptr(bp), slo, shi,
                                             _build.ptr(lo), _build.ptr(hi), _build.stream_ptr()),
                 "ph2_fr_powers_mul_array")
    fr_powers_mul_array.launches += 1
    return out


fr_powers_mul_array.launches = 0
