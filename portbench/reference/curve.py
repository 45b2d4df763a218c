"""BLS12-381 G1/G2 group arithmetic and blst-compatible (de)serialization.

The benchmark's frozen copy of ``plutus_halo2_tpu_torch/refimpl/curve.py``;
it imports nothing of the port. Replaces the
reference's reliance on Plutus builtins (`bls12_381_G1_*`) and mirrors the
compressed-point bit conventions of `CompressUncompress.hs:51-97`:
byte 0 flags: 0x80 compressed, 0x40 infinity, 0x20 sign (y > -y).

Points are affine tuples; G1: (x, y) ints or None for infinity.
G2: ((x0, x1), (y0, y1)) over Fp2 = Fp[u]/(u^2+1), or None.
Internally Jacobian coordinates are used for speed.
"""

from __future__ import annotations

from .field import P, Q, fp_inv, fp_sqrt

G1_B = 4
# Fp2 twist constant: E'/Fp2 : y^2 = x^3 + 4(u+1)
G2_B = (4, 4)

# Group generators (standard BLS12-381 values, cf. the compressed generator
# constants used by the reference via Plutus builtins)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# ---------------------------------------------------------------------------
# Fp2 helpers (shared with tower.py-level code; kept tuple-based and minimal)
# ---------------------------------------------------------------------------

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sqr(a):
    # (a0^2 - a1^2, 2 a0 a1)
    t0 = (a[0] + a[1]) % P
    t1 = (a[0] - a[1]) % P
    return (t0 * t1 % P, 2 * a[0] * a[1] % P)


def fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = fp_inv(norm)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def fp2_is_zero(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fp2_sqrt(a):
    """Square root in Fp2 (p ≡ 3 mod 4): candidate a^((p^2+7)/16)-style method.

    Uses the simple approach: s = a^((p-3)/4)-based... here: exponentiation
    a^((p^2+7)/16) is for p ≡ 9 mod 16; for Fp2 over p ≡ 3 mod 4 we use
    Algorithm 9 of https://eprint.iacr.org/2012/685: a1 = a^((p-3)/4),
    alpha = a1^2 * a, x0 = a1 * a; if alpha == -1 -> x = u * x0 else
    x = (1+alpha)^((p-1)/2) * x0. Returns None if no root."""
    if fp2_is_zero(a):
        return (0, 0)
    a1 = fp2_pow(a, (P - 3) >> 2)
    alpha = fp2_mul(fp2_sqr(a1), a)
    x0 = fp2_mul(a1, a)
    if alpha == ((P - 1) % P, 0):
        x = fp2_mul((0, 1), x0)
    else:
        b = fp2_pow(fp2_add((1, 0), alpha), (P - 1) >> 1)
        x = fp2_mul(b, x0)
    if fp2_sqr(x) != (a[0] % P, a[1] % P):
        return None
    return x


def fp2_pow(a, e: int):
    r = (1, 0)
    base = a
    while e > 0:
        if e & 1:
            r = fp2_mul(r, base)
        base = fp2_sqr(base)
        e >>= 1
    return r


# ---------------------------------------------------------------------------
# Generic short-Weierstrass Jacobian arithmetic, parametrized by the field ops.
# One implementation serves G1 (over Fp) and G2 (over Fp2).
# ---------------------------------------------------------------------------

class _FieldOps:
    __slots__ = ("add", "sub", "neg", "mul", "sqr", "inv", "is_zero", "zero", "one")

    def __init__(self, add, sub, neg, mul, sqr, inv, is_zero, zero, one):
        self.add, self.sub, self.neg = add, sub, neg
        self.mul, self.sqr, self.inv = mul, sqr, inv
        self.is_zero, self.zero, self.one = is_zero, zero, one


_FP_OPS = _FieldOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    neg=lambda a: (-a) % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    inv=fp_inv,
    is_zero=lambda a: a % P == 0,
    zero=0,
    one=1,
)

_FP2_OPS = _FieldOps(
    add=fp2_add,
    sub=fp2_sub,
    neg=fp2_neg,
    mul=fp2_mul,
    sqr=fp2_sqr,
    inv=fp2_inv,
    is_zero=fp2_is_zero,
    zero=(0, 0),
    one=(1, 0),
)


def _jac_double(F: _FieldOps, pt):
    X, Y, Z = pt
    if F.is_zero(Z):
        return pt
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.sub(F.sqr(F.add(X, B)), F.add(A, C))
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    Fv = F.sqr(E)
    X3 = F.sub(Fv, F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(F.add(Y, Y), Z)
    return (X3, Y3, Z3)


def _jac_add(F: _FieldOps, p1, p2):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if F.is_zero(Z1):
        return p2
    if F.is_zero(Z2):
        return p1
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return (F.one, F.one, F.zero)  # infinity
        return _jac_double(F, p1)
    H = F.sub(U2, U1)
    I = F.sqr(F.add(H, H))
    J = F.mul(H, I)
    r = F.sub(S2, S1)
    r = F.add(r, r)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.add(V, V))
    S1J = F.mul(S1, J)
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(S1J, S1J))
    Z3 = F.mul(F.mul(F.sub(F.sqr(F.add(Z1, Z2)), F.add(Z1Z1, Z2Z2)), H), F.one)
    # Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H  (= 2 Z1 Z2 H)
    return (X3, Y3, Z3)


def _jac_from_affine(F: _FieldOps, pt):
    if pt is None:
        return (F.one, F.one, F.zero)
    return (pt[0], pt[1], F.one)


def _jac_to_affine(F: _FieldOps, pt):
    X, Y, Z = pt
    if F.is_zero(Z):
        return None
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    zi3 = F.mul(zi2, zi)
    return (F.mul(X, zi2), F.mul(Y, zi3))


def _mul(F: _FieldOps, pt, k: int):
    k = int(k)
    if k < 0:
        raise ValueError("negative scalar")
    acc = (F.one, F.one, F.zero)
    base = _jac_from_affine(F, pt)
    while k > 0:
        if k & 1:
            acc = _jac_add(F, acc, base)
        base = _jac_double(F, base)
        k >>= 1
    return _jac_to_affine(F, acc)


# --- G1 public API ---------------------------------------------------------

def g1_add(p1, p2):
    return _jac_to_affine(_FP_OPS, _jac_add(_FP_OPS, _jac_from_affine(_FP_OPS, p1), _jac_from_affine(_FP_OPS, p2)))


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


def g1_mul(p, k: int):
    """Scalar multiplication with the Plutus builtin's semantics
    (bls12_381_G1_scalarMul reduces the scalar mod the G1 order q). Correct
    for G1 members; for raw E(Fp) points with cofactor components use
    g1_mul_unreduced / g1_in_subgroup."""
    return _mul(_FP_OPS, p, k % Q)


def g1_mul_unreduced(p, k: int):
    """[k]P on E(Fp) WITHOUT reducing k mod q — needed when p may lie outside
    the q-order subgroup (the reduced form silently maps [q]P to the identity
    for EVERY point, hiding cofactor components)."""
    return _mul(_FP_OPS, p, k)


def g1_in_subgroup(p) -> bool:
    """Exact q-order subgroup membership of an E(Fp) point: [q]P == O with an
    unreduced ladder (identity is a member)."""
    return p is None or g1_mul_unreduced(p, Q) is None


def g1_msm(scalars, points):
    """Naive MSM — spec semantics of the reference's sequential fold
    (MSMEval.hs:18-27). The batched implementations use windowed methods."""
    acc = (_FP_OPS.one, _FP_OPS.one, _FP_OPS.zero)
    for s, pt in zip(scalars, points):
        term = _mul(_FP_OPS, pt, int(s))
        acc = _jac_add(_FP_OPS, acc, _jac_from_affine(_FP_OPS, term))
    return _jac_to_affine(_FP_OPS, acc)


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + G1_B)) % P == 0


def g1_compress(p) -> bytes:
    """48-byte blst compressed encoding (CompressUncompress.hs:67-79)."""
    if p is None:
        return bytes([0xC0] + [0] * 47)
    x, y = p
    flags = 0x80
    if y > P - y:  # y > -y  => sign bit (0xa0 case in the reference)
        flags |= 0x20
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g1_decompress(b: bytes):
    """Inverse of g1_compress (CompressUncompress.hs:81-97). Raises ValueError
    for encodings blst would reject."""
    if len(b) != 48:
        raise ValueError("G1 compressed encoding must be 48 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("uncompressed serialization not supported")
    if flags & 0x40:
        if flags & 0x20 or any(b[1:]) or (b[0] & 0x3F):
            raise ValueError("invalid infinity encoding")
        return None
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
    if x >= P:
        raise ValueError("x not in field")
    y = fp_sqrt((x * x * x + G1_B) % P)
    if y is None:
        raise ValueError("x not on curve")
    sign = bool(flags & 0x20)
    if (sign and y < P - y) or (not sign and y > P - y):
        y = P - y
    return (x, y)


# --- G2 public API ---------------------------------------------------------

def g2_add(p1, p2):
    return _jac_to_affine(_FP2_OPS, _jac_add(_FP2_OPS, _jac_from_affine(_FP2_OPS, p1), _jac_from_affine(_FP2_OPS, p2)))


def g2_neg(p):
    if p is None:
        return None
    return (p[0], fp2_neg(p[1]))


def g2_mul(p, k: int):
    return _mul(_FP2_OPS, p, k)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = fp2_sqr(y)
    rhs = fp2_add(fp2_mul(fp2_sqr(x), x), G2_B)
    return lhs == rhs


def _fp2_lex_gt_neg(y) -> bool:
    """blst sign convention for Fp2: compare (y1, y0) lexicographically with -y."""
    ny = fp2_neg(y)
    if y[1] != ny[1]:
        return y[1] > ny[1]
    return y[0] > ny[0]


def g2_compress(p) -> bytes:
    """96-byte blst compressed encoding: BE(x1) || BE(x0) with flag bits."""
    if p is None:
        return bytes([0xC0] + [0] * 95)
    (x0, x1), y = p
    flags = 0x80
    if _fp2_lex_gt_neg(y):
        flags |= 0x20
    b = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g2_decompress(b: bytes):
    if len(b) != 96:
        raise ValueError("G2 compressed encoding must be 96 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("uncompressed serialization not supported")
    if flags & 0x40:
        if flags & 0x20 or any(b[1:]) or (b[0] & 0x3F):
            raise ValueError("invalid infinity encoding")
        return None
    x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("x not in field")
    x = (x0, x1)
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sqr(x), x), G2_B))
    if y is None:
        raise ValueError("x not on curve")
    sign = bool(flags & 0x20)
    if _fp2_lex_gt_neg(y) != sign:
        y = fp2_neg(y)
    return (x, y)
