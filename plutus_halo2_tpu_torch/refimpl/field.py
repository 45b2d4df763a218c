"""BLS12-381 base/scalar field constants and arithmetic helpers (executable spec).

The port's own copy of ``plutus_halo2_tpu/refimpl/field.py`` (the port imports
nothing of the JAX package). Pure-Python big-int reference semantics for the
limb arithmetic in ``plutus_halo2_tpu_torch.ops`` and the CUDA kernels in
``csrc/``. Mirrors the on-chain field layer of the reference
(`plinth-verifier/plutus-halo2/src/Plutus/Crypto/BlsTypes.hs:96-212`): scalars
and base-field elements are integers mod q / mod p; inversion and square roots
use fixed exponent chains.
"""

from __future__ import annotations

# Base field prime (Fp), reference BlsTypes.hs:101-103
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field prime (Fr), reference BlsTypes.hs:96-97
Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Multiplicative generator of Fr (blstrs Scalar::MULTIPLICATIVE_GENERATOR)
FR_GENERATOR = 7
# 2-adicity of Fr: q - 1 = 2^32 * t
FR_TWO_ADICITY = 32
# 2^32-th primitive root of unity in Fr (derived, not hardcoded)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (Q - 1) >> FR_TWO_ADICITY, Q)
# delta = g^(2^s): generator of the order-t subgroup; used for permutation-argument
# cosets (reference Constants.hs:10-13, halo2 Scalar::DELTA)
FR_DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, Q)

# Transcript challenge folding constant R = 2^256 mod q (reference Transcript.hs:78-79)
R_SHIFT_256 = pow(2, 256, Q)

# BLS parameter x (negative); |x| drives the Miller loop and the G2 cofactor maps.
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True


def fr(x: int) -> int:
    """Canonical Fr representative (mkScalar, BlsTypes.hs:128-130)."""
    return x % Q


def fp(x: int) -> int:
    """Canonical Fp representative (mkFp)."""
    return x % P


def fr_inv(x: int) -> int:
    """Inverse in Fr. Spec form of the extended-Euclid `recip` (BlsTypes.hs:200-212)."""
    if x % Q == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(x, Q - 2, Q)


def fp_inv(x: int) -> int:
    if x % P == 0:
        raise ZeroDivisionError("inverse of zero in Fp")
    return pow(x, P - 2, P)


def fp_sqrt(x: int) -> int | None:
    """Square root in Fp (p ≡ 3 mod 4), as used for point decompression
    (reference CompressUncompress.hs:95). Returns None for non-residues."""
    x = x % P
    y = pow(x, (P + 1) >> 2, P)
    if y * y % P != x:
        return None
    return y


def fr_batch_inv(xs: list[int]) -> list[int]:
    """Montgomery-trick batch inversion, the algorithm of the reference's
    batchInverses (LagrangePolynomialEvaluation.hs:60-76 / lagrange.ak:98-130)."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % Q
    inv_all = fr_inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % Q
        inv_all = inv_all * xs[i] % Q
    return out


def fr_from_le_bytes(b: bytes) -> int:
    """Scalar from 32 little-endian bytes, reduced mod q (Proof.hs:59-64,
    transcript.ak:29-45 — overflow wraps, see overflow_scalar_deserialization test)."""
    return int.from_bytes(b, "little") % Q


def fr_to_le_bytes(x: int) -> bytes:
    return (x % Q).to_bytes(32, "little")
