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


# ---------------------------------------------------------------------------
# The Pallas kernel's tower (plutus_halo2_tpu/ops/pallas_pairing.py:69-404),
# step for step and stack for stack: every formula is one stacked batch of
# independent Fp2 products. The pairing kernel (csrc/pairing.cu) runs
# programs traced from these functions (ops/pairing_program.py), so they are
# generic over the field object F (add, sub, neg, mul, inv, one, zeros): the
# port's ``fp`` for the plain version, a symbolic field for the tracer.
# Layout as above: Fp2 (..., 2, L), Fp6 (..., 3, 2, L), Fp12 (..., 6, 2, L).
# ---------------------------------------------------------------------------

def _c(a, i):
    """Coefficient i of an extension element (..., n, 2, L) -> (..., 2, L)."""
    return a[..., i, :, :]


def k2_add(a, b, F=fp):
    return torch.stack([F.add(a[..., 0, :], b[..., 0, :]), F.add(a[..., 1, :], b[..., 1, :])], -2)


def k2_sub(a, b, F=fp):
    return torch.stack([F.sub(a[..., 0, :], b[..., 0, :]), F.sub(a[..., 1, :], b[..., 1, :])], -2)


def k2_neg(a, F=fp):
    return torch.stack([F.neg(a[..., 0, :]), F.neg(a[..., 1, :])], -2)


def k2_conj(a, F=fp):
    return torch.stack([a[..., 0, :], F.neg(a[..., 1, :])], -2)


def k2_double(a, F=fp):
    return k2_add(a, a, F)


def k2_xi(a, F=fp):
    """(u + 1) a."""
    return torch.stack([F.sub(a[..., 0, :], a[..., 1, :]), F.add(a[..., 0, :], a[..., 1, :])], -2)


def k2_mul(a, b, F=fp):
    """Karatsuba: 3 Fp products over the stack."""
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    m0, m1 = F.mul(a0, b0), F.mul(a1, b1)
    m2 = F.mul(F.add(a0, a1), F.add(b0, b1))
    return torch.stack([F.sub(m0, m1), F.sub(m2, F.add(m0, m1))], -2)


def k2_sqr(a, F=fp):
    """Complex squaring: 2 Fp products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t0 = F.mul(F.add(a0, a1), F.sub(a0, a1))
    t1 = F.mul(a0, a1)
    return torch.stack([t0, F.add(t1, t1)], -2)


def k2_mul_fp(a, s, F=fp):
    return torch.stack([F.mul(a[..., 0, :], s), F.mul(a[..., 1, :], s)], -2)


def k2_inv(a, F=fp):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    ninv = F.inv(F.add(F.mul(a0, a0), F.mul(a1, a1)))
    return torch.stack([F.mul(a0, ninv), F.neg(F.mul(a1, ninv))], -2)


def _k6_combine(pr, F):
    """The 3-way Karatsuba outputs from the six products (v0, v1, v2, m01,
    m02, m12) on axis -3."""
    v0, v1, v2, m01, m02, m12 = (_c(pr, i) for i in range(6))
    c0 = k2_add(v0, k2_xi(k2_sub(m12, k2_add(v1, v2, F), F), F), F)
    c1 = k2_add(k2_sub(m01, k2_add(v0, v1, F), F), k2_xi(v2, F), F)
    c2 = k2_add(k2_sub(m02, k2_add(v0, v2, F), F), v1, F)
    return torch.stack([c0, c1, c2], -3)


def _k6_operands(a, F):
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    return torch.stack([a0, a1, a2, k2_add(a0, a1, F), k2_add(a0, a2, F), k2_add(a1, a2, F)], -3)


def k6_mul(a, b, F=fp):
    """3-way Karatsuba: 6 Fp2 products in one stack. a, b (..., 3, 2, L);
    extra leading axes are stacked products (the Pallas kernel's
    _k6_mul_stacked)."""
    return _k6_combine(k2_mul(_k6_operands(a, F), _k6_operands(b, F), F), F)


def k6_mul_by_v(a, F=fp):
    return torch.stack([k2_xi(_c(a, 2), F), _c(a, 0), _c(a, 1)], -3)


def k6_inv(a, F=fp):
    a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
    pr = k2_mul(torch.stack([a0, a1, a2, a0, a1, a0], -3), torch.stack([a0, a2, a2, a1, a1, a2], -3), F)
    c0 = k2_sub(_c(pr, 0), k2_xi(_c(pr, 1), F), F)
    c1 = k2_sub(k2_xi(_c(pr, 2), F), _c(pr, 3), F)
    c2 = k2_sub(_c(pr, 4), _c(pr, 5), F)
    cs = torch.stack([c0, c1, c2], -3)
    pr2 = k2_mul(torch.stack([a0, a2, a1], -3), cs, F)
    t = k2_add(_c(pr2, 0), k2_xi(k2_add(_c(pr2, 1), _c(pr2, 2), F), F), F)
    return k2_mul(cs, k2_inv(t, F).unsqueeze(-3), F)


def _split(a):
    """Fp12 (..., 6, 2, L) -> even (a0, a2, a4), odd (a1, a3, a5) Fp6 halves."""
    return a[..., 0::2, :, :], a[..., 1::2, :, :]


def _join(even, odd):
    return torch.stack([even, odd], -3).reshape(*even.shape[:-3], 6, *even.shape[-2:])


def k12_one(shape, device, F=fp):
    c0 = torch.stack([F.one(shape, device), F.zeros(shape, device)], -2)
    return torch.cat([c0.unsqueeze(-3), torch.zeros_like(c0).unsqueeze(-3).expand(*shape, 5, *c0.shape[-2:])], -3)


def k12_mul(a, b, F=fp):
    """Quadratic Karatsuba over Fp6: 3 Fp6 products = 18 Fp2 products."""
    A0, A1 = _split(a)
    B0, B1 = _split(b)
    pr = k6_mul(torch.stack([A0, A1, k2_add(A0, A1, F)], -4), torch.stack([B0, B1, k2_add(B0, B1, F)], -4), F)
    t0, t1, t2 = pr[..., 0, :, :, :], pr[..., 1, :, :, :], pr[..., 2, :, :, :]
    return _join(k2_add(t0, k6_mul_by_v(t1, F), F), k2_sub(t2, k2_add(t0, t1, F), F))


def k12_sqr(a, F=fp):
    """Complex squaring over Fp6: 2 Fp6 products = 12 Fp2 products."""
    A0, A1 = _split(a)
    pr = k6_mul(torch.stack([A0, k2_add(A0, A1, F)], -4),
                torch.stack([A1, k2_add(A0, k6_mul_by_v(A1, F), F)], -4), F)
    t, s = pr[..., 0, :, :, :], pr[..., 1, :, :, :]
    return _join(k2_sub(s, k2_add(t, k6_mul_by_v(t, F), F), F), k2_double(t, F))


def k12_cyc_sqr(a, F=fp):
    """Granger-Scott cyclotomic squaring: 9 Fp2 squarings in one stack.
    Valid only in the cyclotomic subgroup (after the easy part)."""
    c = [_c(a, i) for i in range(6)]
    sq = k2_sqr(torch.stack([c[3], c[0], k2_add(c[3], c[0], F), c[4], c[1], k2_add(c[4], c[1], F),
                             c[5], c[2], k2_add(c[5], c[2], F)], -3), F)
    s3, s0, s30, s4, s1, s41, s5, s2, s52 = (_c(sq, i) for i in range(9))
    A = k2_add(s0, k2_xi(s3, F), F)
    Bv = k2_add(s1, k2_xi(s4, F), F)
    C = k2_add(s2, k2_xi(s5, F), F)
    t6 = k2_sub(s30, k2_add(s3, s0, F), F)  # 2 a0 a3
    t7 = k2_sub(s41, k2_add(s4, s1, F), F)  # 2 a1 a4
    t8 = k2_xi(k2_sub(s52, k2_add(s5, s2, F), F), F)  # 2 xi a2 a5

    def three_minus_two(t, x):
        return k2_add(k2_double(k2_sub(t, x, F), F), t, F)

    def three_plus_two(t, x):
        return k2_add(k2_double(k2_add(t, x, F), F), t, F)

    return torch.stack([three_minus_two(A, c[0]), three_plus_two(t8, c[1]), three_minus_two(Bv, c[2]),
                        three_plus_two(t6, c[3]), three_minus_two(C, c[4]), three_plus_two(t7, c[5])], -3)


def k12_mul_sparse023(f, c0, c2, c3, F=fp):
    """f (c0 + c2 w^2 + c3 w^3), the M-twist line: 13 Fp2 products in one
    stack (even part L0 = (c0, c2, 0), odd L1 = (0, c3, 0))."""
    F0, F1 = _split(f)
    f00, f01, f02 = _c(F0, 0), _c(F0, 1), _c(F0, 2)
    f10, f11, f12 = _c(F1, 0), _c(F1, 1), _c(F1, 2)
    g0, g1, g2 = k2_add(f00, f10, F), k2_add(f01, f11, F), k2_add(f02, f12, F)
    c23 = k2_add(c2, c3, F)
    c0, c2, c3, c23 = torch.broadcast_tensors(c0, c2, c3, c23)
    lhs = torch.stack([f00, f01, k2_add(f00, f01, F), k2_add(f00, f02, F), k2_add(f01, f02, F),
                       f12, f10, f11,
                       g0, g1, k2_add(g0, g1, F), k2_add(g0, g2, F), k2_add(g1, g2, F)], -3)
    rhs = torch.stack([c0, c2, k2_add(c0, c2, F), c0, c2,
                       c3, c3, c3,
                       c0, c23, k2_add(c0, c23, F), c0, c23], -3)
    p = [_c(k2_mul(lhs, rhs, F), i) for i in range(13)]

    def sparse5(v0, v1, m01, m02, m12):
        return torch.stack([k2_add(v0, k2_xi(k2_sub(m12, v1, F), F), F),
                            k2_sub(m01, k2_add(v0, v1, F), F),
                            k2_add(k2_sub(m02, v0, F), v1, F)], -3)

    t0 = sparse5(*p[0:5])
    t1 = torch.stack([k2_xi(p[5], F), p[6], p[7]], -3)
    t2 = sparse5(*p[8:13])
    return _join(k2_add(t0, k6_mul_by_v(t1, F), F), k2_sub(t2, k2_add(t0, t1, F), F))


def k12_conj(a, F=fp):
    even, odd = _split(a)
    return _join(even, k2_neg(odd, F))


def k12_frobenius(a, gam_k, odd: bool, F=fp):
    """Conjugate the coefficients (odd k), then scale coefficient i by
    gamma_k^i (gam_k (6, 2, L), ``_GAMMAS[k]`` on the device)."""
    return k2_mul(k2_conj(a, F) if odd else a, gam_k, F)


def k12_inv(a, F=fp):
    A, B = _split(a)
    pr = k6_mul(torch.stack([A, B], -4), torch.stack([A, B], -4), F)  # A^2, B^2
    D = k2_sub(pr[..., 0, :, :, :], k6_mul_by_v(pr[..., 1, :, :, :], F), F)
    Dinv = k6_inv(D, F)
    pr2 = k6_mul(torch.stack([A, B], -4), torch.stack([Dinv, Dinv], -4), F)
    return _join(pr2[..., 0, :, :, :], k2_neg(pr2[..., 1, :, :, :], F))
