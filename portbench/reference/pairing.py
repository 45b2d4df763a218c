"""BLS12-381 ate pairing (executable spec): the benchmark's frozen
copy of ``plutus_halo2_tpu_torch/refimpl/pairing.py``.

Spec-level replacement for the Plutus builtins `bls12_381_millerLoop` /
`bls12_381_finalVerify` used by the generated verifiers (e.g.
`plinth-verifier/templates/verification_halo2_kzg.hbs:211-216`). The batched
implementation is the pairing kernel (``ops/cuda_pairing.py``, ``csrc/pairing.cu``)
and its plain version ``ops/pairing.py``; this module is their oracle.

Representation: Fp12 as a length-12 coefficient list over Fp modulo
w^12 - 2 w^6 + 2 (so Fp2 embeds via u = w^6 - 1). Lines are evaluated on
points lifted to E(Fp12) via the twist map. The Miller loop omits the final
conjugation for negative x; combined with the final exponentiation this yields
the inverse of the canonical ate pairing, which is a bilinear non-degenerate
pairing itself, so *equality checks* (finalVerify semantics) are unaffected.
"""

from __future__ import annotations

from .field import P, Q, BLS_X
from .curve import G1_GEN, G2_GEN

# modulus poly: w^12 = 2 w^6 - 2
_MOD_LOW = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0)

FP12_ONE = (1,) + (0,) * 11
FP12_ZERO = (0,) * 12


def fp12_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def fp12_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def fp12_neg(a):
    return tuple((-x) % P for x in a)


def fp12_scalar(a, k):
    return tuple(x * k % P for x in a)


def fp12_mul(a, b):
    t = [0] * 23
    for i, x in enumerate(a):
        if x == 0:
            continue
        for j, y in enumerate(b):
            t[i + j] += x * y
    # reduce degrees 22..12 using w^12 = 2w^6 - 2
    for d in range(22, 11, -1):
        c = t[d]
        if c == 0:
            continue
        t[d] = 0
        t[d - 6] += 2 * c
        t[d - 12] -= 2 * c
    return tuple(x % P for x in t[:12])


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_pow(a, e: int):
    r = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            r = fp12_mul(r, base)
        base = fp12_mul(base, base)
        e >>= 1
    return r


def fp12_inv(a):
    """Inverse via extended Euclid on polynomials over Fp (spec-only; slow path)."""
    # polynomial gcd of a(w) and m(w) = w^12 - 2w^6 + 2
    from .field import fp_inv

    def poly_mod(num, den):
        num = list(num)
        dd = len(den) - 1
        dinv = fp_inv(den[-1])
        while len(num) - 1 >= dd and any(num):
            if num[-1] == 0:
                num.pop()
                continue
            shift = len(num) - 1 - dd
            factor = num[-1] * dinv % P
            for i, c in enumerate(den):
                num[shift + i] = (num[shift + i] - factor * c) % P
            num.pop()
        return num

    def poly_divmod(num, den):
        num = list(num)
        dd = len(den) - 1
        dinv = fp_inv(den[-1])
        quot = [0] * (max(len(num) - dd, 0))
        while len(num) - 1 >= dd:
            if num[-1] == 0:
                num.pop()
                continue
            shift = len(num) - 1 - dd
            factor = num[-1] * dinv % P
            quot[shift] = factor
            for i, c in enumerate(den):
                num[shift + i] = (num[shift + i] - factor * c) % P
            num.pop()
        while num and num[-1] == 0:
            num.pop()
        return quot, num

    def poly_mul(x, y):
        out = [0] * (len(x) + len(y) - 1)
        for i, xv in enumerate(x):
            if xv:
                for j, yv in enumerate(y):
                    out[i + j] = (out[i + j] + xv * yv) % P
        return out

    def poly_sub(x, y):
        n = max(len(x), len(y))
        x = x + [0] * (n - len(x))
        y = y + [0] * (n - len(y))
        return [(u - v) % P for u, v in zip(x, y)]

    m = [2, 0, 0, 0, 0, 0, -2 % P, 0, 0, 0, 0, 0, 1]
    r0, r1 = m, [c % P for c in a]
    while r1 and r1[-1] == 0:
        r1.pop()
    s0, s1 = [0], [1]
    while True:
        if len(r1) == 1:
            inv_c = fp_inv(r1[0])
            res = [c * inv_c % P for c in s1]
            res = poly_mod(res, m) if len(res) > 12 else res
            return tuple((res + [0] * 12)[:12])
        q, r = poly_divmod(r0, r1)
        r0, r1 = r1, r
        s0, s1 = s1, poly_sub(s0, poly_mul(q, s1))
        if not r1:
            raise ZeroDivisionError("non-invertible Fp12 element")


def fp12_conjugate(a):
    """f -> f^(p^6): negate odd coefficients (w -> -w)."""
    return tuple((-c) % P if i % 2 else c % P for i, c in enumerate(a))


# --- twist embedding -------------------------------------------------------

def fp2_to_fp12(a):
    """Embed a0 + a1 u with u = w^6 - 1."""
    c = [0] * 12
    c[0] = (a[0] - a[1]) % P
    c[6] = a[1] % P
    return tuple(c)


def twist_g2(pt):
    """Lift an affine G2 point from E'/Fp2 (M-twist, b' = 4(u+1)) to E(Fp12):
    (x', y') -> (x'/w^2, y'/w^3), valid because w^6 = u + 1 in this basis."""
    if pt is None:
        return None
    x, y = pt
    w = (0, 1) + (0,) * 10
    w_inv = fp12_inv(w)
    w2_inv = fp12_mul(w_inv, w_inv)
    w3_inv = fp12_mul(w2_inv, w_inv)
    return (fp12_mul(fp2_to_fp12(x), w2_inv), fp12_mul(fp2_to_fp12(y), w3_inv))


def lift_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return ((x,) + (0,) * 11, (y,) + (0,) * 11)


# --- Miller loop -----------------------------------------------------------

def _line(p1, p2, t):
    """Evaluate the line through p1, p2 (E(Fp12) affine) at point t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        num = fp12_sub(y2, y1)
        den = fp12_sub(x2, x1)
        m = fp12_mul(num, fp12_inv(den))
        return fp12_sub(fp12_mul(m, fp12_sub(xt, x1)), fp12_sub(yt, y1))
    if y1 == y2:
        num = fp12_scalar(fp12_mul(x1, x1), 3)
        den = fp12_scalar(y1, 2)
        m = fp12_mul(num, fp12_inv(den))
        return fp12_sub(fp12_mul(m, fp12_sub(xt, x1)), fp12_sub(yt, y1))
    return fp12_sub(xt, x1)


def _ec_add12(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == fp12_neg(y2):
        return None
    if p1 == p2:
        m = fp12_mul(fp12_scalar(fp12_mul(x1, x1), 3), fp12_inv(fp12_scalar(y1, 2)))
    else:
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_mul(m, m), x1), x2)
    y3 = fp12_sub(fp12_mul(m, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(p_g1, q_g2):
    """Miller loop f_{|x|,Q}(P). Returns Fp12 (no final exponentiation),
    matching the role of the Plutus `bls12_381_millerLoop` builtin."""
    if p_g1 is None or q_g2 is None:
        return FP12_ONE
    P12 = lift_g1(p_g1)
    Q12 = twist_g2(q_g2)
    R = Q12
    f = FP12_ONE
    bits = bin(BLS_X)[3:]  # skip MSB
    for bit in bits:
        f = fp12_mul(fp12_sqr(f), _line(R, R, P12))
        R = _ec_add12(R, R)
        if bit == "1":
            f = fp12_mul(f, _line(R, Q12, P12))
            R = _ec_add12(R, Q12)
    return f


_FINAL_EXP = (P**12 - 1) // Q


def final_exponentiation(f):
    return fp12_pow(f, _FINAL_EXP)


def final_verify(ml1, ml2) -> bool:
    """Semantics of `bls12_381_finalVerify ml1 ml2`: checks
    finalExp(ml1 / ml2)? The builtin checks e-products equal, i.e.
    finalExp(ml1 * conj(ml2)) == 1, equivalently finalExp(ml1) == finalExp(ml2)."""
    return final_exponentiation(fp12_mul(ml1, fp12_inv(ml2))) == FP12_ONE


def pairing_check(pairs) -> bool:
    """Check prod e(Pi, Qi) == 1 for [(Pi, Qi)]."""
    f = FP12_ONE
    for p1, q2 in pairs:
        f = fp12_mul(f, miller_loop(p1, q2))
    return final_exponentiation(f) == FP12_ONE
