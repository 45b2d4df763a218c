"""Polynomial arithmetic over Fr: radix-2 NTT, coset LDE, domains — the
port's copy of ``plutus_halo2_tpu/refimpl/poly.py``.

Spec-side machinery for the native prover (the reference delegates proving to
its halo2 fork; here it is first-class). All values are Python ints mod Q.

Where the JAX package hands an array of ``_NATIVE_MIN_N`` or more elements
to its host C++ runtime (``ntt``, the coset weighting of
``coset_evaluate`` / ``coset_interpolate``, ``poly_scale``), this module
hands it to the Fr kernels of ``ops/cuda_poly.py`` on the device the
caller names: ``device=None`` is the card (``resolve_device`` raises
without one), ``device="cpu"`` the kernels' plain versions. A chain of
them (``intt``, the coset transforms) stays on the device between steps.
There is no fallback: a failed build or launch raises. Below
``_NATIVE_MIN_N`` the Python-int path runs, as in the JAX package."""

from __future__ import annotations

import torch

from ..models.verifier_torch import resolve_device as _device
from ..ops import cuda_poly
from ..ops import poly as words
from .field import Q, FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, fr_inv

# the JAX package's threshold for its host runtime, kept so that the same
# arrays go to the kernels
_NATIVE_MIN_N = 128


def domain_omega(k: int) -> int:
    """Primitive 2^k-th root of unity (halo2 EvaluationDomain omega)."""
    assert k <= FR_TWO_ADICITY
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), Q)


def _bit_reverse(a: list[int]) -> list[int]:
    n = len(a)
    j = 0
    a = list(a)
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    return a


def _ntt_py(a: list[int], omega: int) -> list[int]:
    n = len(a)
    a = _bit_reverse(a)
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, Q)
        for start in range(0, n, length):
            w = 1
            half = length >> 1
            for j in range(start, start + half):
                u = a[j]
                v = a[j + half] * w % Q
                a[j] = (u + v) % Q
                a[j + half] = (u - v) % Q
                w = w * w_len % Q
        length <<= 1
    return a


def ntt(a: list[int], omega: int, device=None) -> list[int]:
    """In-order radix-2 NTT: a_j -> sum_i a_i omega^{ij}."""
    n = len(a)
    assert n & (n - 1) == 0
    if n >= _NATIVE_MIN_N:
        return words.from_words(cuda_poly.fr_ntt(words.to_words(a, _device(device)), omega))
    return _ntt_py(a, omega)


def intt(a: list[int], omega: int, device=None) -> list[int]:
    n = len(a)
    inv_n = fr_inv(n)
    if n >= _NATIVE_MIN_N:
        t = cuda_poly.fr_ntt(words.to_words(a, _device(device)), fr_inv(omega))
        return words.from_words(cuda_poly.fr_scale_array(t, inv_n))
    return poly_scale(_ntt_py(a, fr_inv(omega)), inv_n)


def lagrange_to_coeff(values: list[int], omega: int, device=None) -> list[int]:
    """Interpolate values over the domain {omega^i} -> coefficient form."""
    return intt(values, omega, device)


def coeff_to_lagrange(coeffs: list[int], omega: int, device=None) -> list[int]:
    return ntt(list(coeffs), omega, device)


def coset_evaluate(coeffs: list[int], ext_size: int, ext_omega: int, coset: int = FR_GENERATOR,
                   device=None) -> list[int]:
    """Evaluate a polynomial on the coset {c * ext_omega^i} of size ext_size."""
    assert len(coeffs) <= ext_size
    if len(coeffs) >= _NATIVE_MIN_N:
        dev = _device(device)
        weighted = cuda_poly.fr_powers_mul_array(words.to_words(coeffs, dev), coset)
        pad = torch.zeros((ext_size - len(coeffs), 8), dtype=weighted.dtype, device=dev)
        return words.from_words(cuda_poly.fr_ntt(torch.cat([weighted, pad]), ext_omega))
    scaled = list(coeffs) + [0] * (ext_size - len(coeffs))
    c_pow = 1
    for i in range(len(coeffs)):
        scaled[i] = scaled[i] * c_pow % Q
        c_pow = c_pow * coset % Q
    return ntt(scaled, ext_omega, device)


def coset_interpolate(values: list[int], ext_omega: int, coset: int = FR_GENERATOR, device=None) -> list[int]:
    c_inv = fr_inv(coset)
    n = len(values)
    if n >= _NATIVE_MIN_N:
        t = cuda_poly.fr_ntt(words.to_words(values, _device(device)), fr_inv(ext_omega))
        t = cuda_poly.fr_scale_array(t, fr_inv(n))
        return words.from_words(cuda_poly.fr_powers_mul_array(t, c_inv))
    coeffs = intt(list(values), ext_omega, device)
    c_pow = 1
    for i in range(len(coeffs)):
        coeffs[i] = coeffs[i] * c_pow % Q
        c_pow = c_pow * c_inv % Q
    return coeffs


def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % Q
    return acc


def poly_divide_linear(coeffs: list[int], z: int) -> list[int]:
    """Exact division by (X - z); the caller guarantees p(z) == 0
    (used for multiopen witness polynomials)."""
    out = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc + coeffs[i]) % Q
        out[i - 1] = acc
        acc = acc * z % Q
    return out


def poly_add(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    a = list(a) + [0] * (n - len(a))
    b = list(b) + [0] * (n - len(b))
    return [(x + y) % Q for x, y in zip(a, b)]


def poly_scale(a: list[int], k: int, device=None) -> list[int]:
    if len(a) >= _NATIVE_MIN_N:
        return words.from_words(cuda_poly.fr_scale_array(words.to_words(a, _device(device)), k))
    return [x * k % Q for x in a]


def mul_array(a: list[int], b: list[int], device=None) -> list[int]:
    """[a_i * b_i] (the JAX package's ``native.mul_array``)."""
    if len(a) >= _NATIVE_MIN_N:
        dev = _device(device)
        return words.from_words(cuda_poly.fr_mul_array(words.to_words(a, dev), words.to_words(b, dev)))
    return [x * y % Q for x, y in zip(a, b)]


def lagrange_basis_coeffs(n: int, omega: int, row: int, device=None) -> list[int]:
    """Coefficients of l_row(X) over the size-n domain."""
    vals = [0] * n
    vals[row] = 1
    return lagrange_to_coeff(vals, omega, device)
