"""Batched Fp2 / Fp6 / Fp12 tower arithmetic in PyTorch: the port of
``plutus_halo2_tpu/ops/tower.py``.

Fp2  = Fp[u]/(u^2 + 1), elements shaped (..., 2, L).
Fp12 = Fp2[w]/(w^6 - xi) with xi = u + 1, elements shaped (..., 6, 2, L)
(coefficients of w^0..w^5); Fp6 = Fp2[v]/(v^3 - xi) with v = w^2.

An Fp12 product runs its 36 coefficient products as ONE batched Karatsuba
Fp2 multiply, applies xi to the products that wrap past w^5, sums each output
coefficient's six products as raw limbs and reduces them in a single
Montgomery pass. The pair order groups the products by output coefficient,
so the sum is a reshape and no routing matrix is needed. Frobenius gammas
are computed on the host from the port's copy of ``refimpl/curve.py``."""

from __future__ import annotations

import numpy as np
import torch

from ..refimpl.curve import fp2_mul as h_fp2_mul
from ..refimpl.curve import fp2_pow
from ..refimpl.field import P
from . import limb
from .limb import FP_SPEC, fp

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def fp2_mul(a, b):
    """Karatsuba: one stacked call of 3 fp muls. a, b: (..., 2, L)."""
    a, b = torch.broadcast_tensors(a, b)
    s = fp.add(torch.stack([a[..., 0, :], b[..., 0, :]], -2),
               torch.stack([a[..., 1, :], b[..., 1, :]], -2))
    m = fp.mul(torch.stack([a[..., 0, :], a[..., 1, :], s[..., 0, :]], -2),
               torch.stack([b[..., 0, :], b[..., 1, :], s[..., 1, :]], -2))
    m01 = fp.add(m[..., 0, :], m[..., 1, :])
    return fp.sub(m[..., 0:3:2, :], torch.stack([m[..., 1, :], m01], -2))


def fp2_sqr(a):
    return fp2_mul(a, a)


def fp2_conj(a):
    return torch.stack([a[..., 0, :], fp.neg(a[..., 1, :])], -2)


def fp2_mul_fp(a, s):
    """Multiply both components by an Fp scalar limb tensor (..., L)."""
    return fp.mul(a, s.unsqueeze(-2))


def fp2_inv(a):
    """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); one Fermat chain."""
    sq = fp.mul(a, a)
    ninv = fp.inv(fp.add(sq[..., 0, :], sq[..., 1, :]))
    return fp2_conj(fp.mul(a, ninv.unsqueeze(-2)))


def _xi(p):
    """xi * p = (p0 - p1, p0 + p1)."""
    p0, p1 = p[..., 0, :], p[..., 1, :]
    return torch.stack([fp.sub(p0, p1), fp.add(p0, p1)], -2)


def fp2_host_to_mont(c) -> np.ndarray:
    """Host: (c0, c1) ints -> (2, L) Montgomery limbs."""
    return np.stack([FP_SPEC.to_mont(c[0]), FP_SPEC.to_mont(c[1])])


# ---------------------------------------------------------------------------
# product routing grouped by output coefficient
# ---------------------------------------------------------------------------

def _routing(n: int, rhs_slots):
    """For an n-coefficient product with rhs coefficients at `rhs_slots`:
    (lhs index, rhs position, wraps) per product, grouped by output slot."""
    li, ri, wrap = [], [], []
    for s in range(n):
        for k, slot in enumerate(rhs_slots):
            i = (s - slot) % n
            li.append(i)
            ri.append(k)
            wrap.append(i + slot >= n)
    return np.array(li), np.array(ri), np.array(wrap)


_R12 = _routing(6, range(6))
_R6 = _routing(3, range(3))
_R023 = _routing(6, (0, 2, 3))


def _routed_product(a, b, route, n):
    li, ri, wrap = route
    dev = a.device
    prods = fp2_mul(a[..., torch.as_tensor(li, device=dev), :, :],
                    b[..., torch.as_tensor(ri, device=dev), :, :])
    w = torch.as_tensor(wrap, device=dev)
    prods = torch.where(w[:, None, None], _xi(prods), prods)
    lazy = prods.reshape(*prods.shape[:-3], n, len(li) // n, 2, FP_SPEC.L).sum(-3)
    return limb.reduce_lazy(FP_SPEC, lazy)


# ---------------------------------------------------------------------------
# Fp12 over w, w^6 = xi = u + 1
# ---------------------------------------------------------------------------

def fp12_zero(shape, device):
    return torch.zeros((*shape, 6, 2, FP_SPEC.L), dtype=torch.int64, device=device)


def fp12_one(shape, device):
    out = fp12_zero(shape, device)
    out[..., 0, 0, :] = FP_SPEC.const("one_mont", device)
    return out


def fp12_mul(a, b):
    """(..., 6, 2, L) x (..., 6, 2, L): one batched fp2 Karatsuba over the 36
    coefficient pairs + xi-wrap + grouped lazy sums + one reduction."""
    return _routed_product(a, b, _R12, 6)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_mul_sparse023(f, c0, c2, c3):
    """Multiply f by a line value l = c0 + c2 w^2 + c3 w^3 (Fp2 coeffs) — the
    M-twist line evaluated on the twist (see ops/pairing.py): 18
    coefficient products as one fp2 mul."""
    return _routed_product(f, torch.stack(torch.broadcast_tensors(c0, c2, c3), -3), _R023, 6)


def fp12_conj(a):
    """f^(p^6): negate the odd w-power coefficients."""
    even = a[..., 0::2, :, :]
    odd = fp.neg(a[..., 1::2, :, :])
    return torch.stack([even, odd], -3).reshape(a.shape)


def _interleave(even, odd):
    return torch.stack([even, odd], -3).reshape(*even.shape[:-3], 6, 2, FP_SPEC.L)


def fp12_inv(a):
    """f = A + B w with A, B in Fp6 = Fp2[v], v = w^2:
    f^-1 = (A - B w) / (A^2 - B^2 v)."""
    A = a[..., 0::2, :, :]
    B = a[..., 1::2, :, :]
    sq = _fp6_mul(torch.stack([A, B]), torch.stack([A, B]))
    D = fp.sub(sq[0], _fp6_mul_by_v(sq[1]))
    Dinv = _fp6_inv(D)
    c = _fp6_mul(torch.stack([A, B]), Dinv)
    return _interleave(c[0], fp.neg(c[1]))


# --- Fp6 helpers on (..., 3, 2, L) over v, v^3 = xi -------------------------

def _fp6_mul_by_v(a):
    """(a0, a1, a2) -> (xi*a2, a0, a1)."""
    return torch.stack([_xi(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], -3)


def _fp6_mul(a, b):
    """Cubic extension product over v (v^3 = xi): 9 coefficient products as
    one batched fp2 mul, grouped lazy sums, one reduction."""
    return _routed_product(a, b, _R6, 3)


def _fp6_inv(a):
    a0, a1, a2 = (a[..., i, :, :] for i in range(3))
    # first product wave: a0^2, a1*a2, a2^2, a0*a1, a1^2, a0*a2
    pr = fp2_mul(torch.stack([a0, a1, a2, a0, a1, a0], -3),
                 torch.stack([a0, a2, a2, a1, a1, a2], -3))
    c0 = fp.sub(pr[..., 0, :, :], _xi(pr[..., 1, :, :]))
    c1 = fp.sub(_xi(pr[..., 2, :, :]), pr[..., 3, :, :])
    c2 = fp.sub(pr[..., 4, :, :], pr[..., 5, :, :])
    # t = a0 c0 + xi (a2 c1 + a1 c2)
    pr2 = fp2_mul(torch.stack([a0, a2, a1], -3), torch.stack([c0, c1, c2], -3))
    t = fp.add(pr2[..., 0, :, :], _xi(fp.add(pr2[..., 1, :, :], pr2[..., 2, :, :])))
    tinv = fp2_inv(t)
    return fp2_mul(torch.stack([c0, c1, c2], -3), tinv.unsqueeze(-3))


# ---------------------------------------------------------------------------
# Frobenius (host-precomputed gamma constants)
# ---------------------------------------------------------------------------

def host_gammas() -> dict:
    """gamma_k[i] = xi^(i*(p^k - 1)/6) in Fp2 for k = 1, 2, 3 as (6, 2, L)
    Montgomery limbs; as ints in ``host_gamma_ints``."""
    return {k: np.stack([fp2_host_to_mont(g) for g in gs]) for k, gs in host_gamma_ints().items()}


def host_gamma_ints() -> dict:
    xi = (1, 1)
    if fp2_pow(xi, (P**6 - 1) // 6) != (P - 1, 0):  # backs fp12_conj
        raise AssertionError("gamma6 must be -1")
    out = {}
    for k in (1, 2, 3):
        base = fp2_pow(xi, (P**k - 1) // 6)
        gam = [(1, 0)]
        for _ in range(5):
            gam.append(h_fp2_mul(gam[-1], base))
        out[k] = gam
    return out


_GAMMAS = host_gammas()


def fp12_frobenius(a, k: int):
    """f^(p^k) for k in {1, 2, 3}: conjugate coefficients (odd k), scale by
    gamma_k^i — one batched fp2 mul over the 6 coefficients."""
    coeffs = fp2_conj(a) if k % 2 == 1 else a
    return fp2_mul(coeffs, torch.as_tensor(_GAMMAS[k], device=a.device))


def fp12_eq(a, b):
    return (a == b).flatten(-3).all(-1)


def fp12_host_to_mont(coeffs6) -> np.ndarray:
    """Host: list of 6 (c0, c1) int pairs -> (6, 2, L)."""
    return np.stack([fp2_host_to_mont(c) for c in coeffs6])
