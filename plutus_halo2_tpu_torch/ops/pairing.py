"""Batched BLS12-381 pairing checks in PyTorch: the port of
``plutus_halo2_tpu/ops/pairing.py``.

In Halo2/KZG verification the G2 arguments (s_g2 and the G2 generator) are
fixed per verifying key, so the whole G2 side of the Miller loop — the
doubling/addition ladder and its line slopes — is precomputed on the host
with exact big-int arithmetic (``prepare_g2``). The batch only evaluates the
sparse line values at its G1 points and accumulates f = f^2 * l ...

Lines on the M-twist evaluated at psi^{-1}(P) = (xp*w^2, yp*w^3):
    l = (y' - lambda' x')  +  (lambda' xp) w^2  -  yp w^3
i.e. sparse Fp12 coefficients at w^0, w^2, w^3.

Final exponentiation uses the identity
    3*(p^4 - p^2 + 1)/q == (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3
(checked at import); exponentiating by 3h instead of h is sound because
mu_q contains no cube roots of unity (gcd(3, q) = 1).

``pairing_check_projective`` is the plain version of the pairing kernel
(``csrc/pairing.cu``)."""

from __future__ import annotations

import numpy as np
import torch

from ..refimpl.curve import fp2_add as h_add
from ..refimpl.curve import fp2_inv as h_inv
from ..refimpl.curve import fp2_mul as h_mul
from ..refimpl.curve import fp2_scalar as h_scalar
from ..refimpl.curve import fp2_sub as h_sub
from ..refimpl.field import BLS_X, P, Q
from . import curve, tower
from .limb import fp
from .tower import (
    fp12_conj,
    fp12_frobenius,
    fp12_inv,
    fp12_mul,
    fp12_mul_sparse023,
    fp12_one,
    fp12_sqr,
    fp2_mul_fp,
)

if 3 * ((P**4 - P**2 + 1) // Q) != ((-BLS_X) - 1) ** 2 * ((-BLS_X) + P) * (BLS_X**2 + P**2 - 1) + 3:
    raise AssertionError("hard-part decomposition of the final exponent")

BITS = bin(BLS_X)[3:]  # Miller loop bit schedule (MSB skipped), 63 steps


# ---------------------------------------------------------------------------
# host-side preparation of a fixed G2 point
# ---------------------------------------------------------------------------

def prepare_g2(q_affine) -> dict:
    """The Miller ladder line constants of a fixed G2 point (twist affine
    ((x0, x1), (y0, y1)) ints): (63, 2, L) int64 Montgomery limbs per line
    array plus the (63,) add mask — the same arrays as the JAX package's
    ``ops/pairing.prepare_g2``. The dummy addition lines of zero bits are
    (lam, c) = (0, 1)."""
    xq, yq = q_affine
    t = (xq, yq)
    out = {"dbl_lam": [], "dbl_c": [], "add_lam": [], "add_c": [], "add_mask": []}
    for bit in BITS:
        x1, y1 = t
        lam = h_mul(h_scalar(h_mul(x1, x1), 3), h_inv(h_scalar(y1, 2)))
        out["dbl_lam"].append(lam)
        out["dbl_c"].append(h_sub(y1, h_mul(lam, x1)))
        x3 = h_sub(h_mul(lam, lam), h_scalar(x1, 2))
        t = (x3, h_sub(h_mul(lam, h_sub(x1, x3)), y1))
        if bit == "1":
            x1, y1 = t
            lam2 = h_mul(h_sub(yq, y1), h_inv(h_sub(xq, x1)))
            out["add_lam"].append(lam2)
            out["add_c"].append(h_sub(y1, h_mul(lam2, x1)))
            out["add_mask"].append(1)
            x3 = h_sub(h_mul(lam2, lam2), h_add(x1, xq))
            t = (x3, h_sub(h_mul(lam2, h_sub(x1, x3)), y1))
        else:
            out["add_lam"].append((0, 0))
            out["add_c"].append((1, 0))  # dummy line multiplies by 1
            out["add_mask"].append(0)
    prep = {k: np.stack([tower.fp2_host_to_mont(v) for v in out[k]])
            for k in ("dbl_lam", "dbl_c", "add_lam", "add_c")}
    prep["add_mask"] = np.asarray(out["add_mask"], dtype=np.int64)
    return prep


# ---------------------------------------------------------------------------
# Miller loop over prepared pairs
# ---------------------------------------------------------------------------

def miller_prepared(pairs):
    """pairs: list of ((xp, yp, inf), prep) where xp, yp are (..., L)
    Montgomery affine Fp coords of G1 points and inf their identity flags
    (or None), prep = prepare_g2 output. Computes prod_j f_{|x|,Qj}(Pj)
    without final exponentiation. A pair flagged inf contributes 1."""
    xp0 = pairs[0][0][0]
    batch, dev = xp0.shape[:-1], xp0.device
    one2 = torch.stack([fp.one(batch, dev), fp.zeros(batch, dev)], -2)
    zero2 = torch.zeros_like(one2)
    evals = []
    for (xp, yp, inf), prep in pairs:
        c3 = torch.stack([fp.neg(yp), fp.zeros(batch, dev)], -2)
        if inf is not None:
            c3 = torch.where(inf[..., None, None], zero2, c3)
        consts = {k: torch.as_tensor(prep[k], device=dev) for k in ("dbl_lam", "dbl_c", "add_lam", "add_c")}
        evals.append((xp, inf, c3, consts))

    def line(f, i, kind):
        for xp, inf, c3, consts in evals:
            c2 = fp2_mul_fp(consts[kind + "_lam"][i], xp)
            c0 = consts[kind + "_c"][i].expand(*batch, 2, fp.L)
            if inf is not None:
                c0 = torch.where(inf[..., None, None], one2, c0)
                c2 = torch.where(inf[..., None, None], zero2, c2)
            f = fp12_mul_sparse023(f, c0, c2, c3)
        return f

    f = fp12_one(batch, dev)
    for i, bit in enumerate(BITS):
        f = line(fp12_sqr(f), i, "dbl")
        if bit == "1":  # zero bits have the dummy line 1: skipped
            f = line(f, i, "add")
    return f


# ---------------------------------------------------------------------------
# final exponentiation
# ---------------------------------------------------------------------------

def _exp_by_neg_x(m):
    """m^x for the (negative) BLS parameter x: square-and-multiply by |x|,
    then conjugate (valid in the cyclotomic subgroup where m^-1 = conj(m))."""
    acc = m
    for bit in BITS:
        acc = fp12_sqr(acc)
        if bit == "1":
            acc = fp12_mul(acc, m)
    return fp12_conj(acc)


def final_exponentiation(f):
    """f^((p^12-1)/q * 3) — the cubed exponent keeps the == 1 test exact."""
    t = fp12_mul(fp12_conj(f), fp12_inv(f))  # easy part: f^(p^6 - 1)
    m = fp12_mul(fp12_frobenius(t, 2), t)  # ^(p^2 + 1)
    a = fp12_mul(_exp_by_neg_x(m), fp12_conj(m))  # m^(x-1)
    b = fp12_mul(_exp_by_neg_x(a), fp12_conj(a))  # m^((x-1)^2)
    c = fp12_mul(_exp_by_neg_x(b), fp12_frobenius(b, 1))  # ^(x+p)
    d = _exp_by_neg_x(_exp_by_neg_x(c))  # c^(x^2)
    e = fp12_mul(fp12_mul(d, fp12_frobenius(c, 2)), fp12_conj(c))  # ^(x^2+p^2-1)
    return fp12_mul(e, fp12_mul(fp12_sqr(m), m))  # * m^3


def pairing_check(pairs):
    """prod e(Pj, Qj) == 1 for prepared pairs; returns (...,) bool."""
    out = final_exponentiation(miller_prepared(pairs))
    return tower.fp12_eq(out, fp12_one(out.shape[:-3], out.device))


def pairing_check_projective(el, er, prep1, prep2):
    """(B, 3, L) projective el/er -> (B,) bool: e(el, Q1) e(er, Q2) == 1,
    with the identity contributing 1 (the verifier's pairing stage)."""
    xs, ys, inf = curve.to_affine(torch.stack([el, er]))
    return pairing_check([((xs[0], ys[0], inf[0]), prep1), ((xs[1], ys[1], inf[1]), prep2)])
