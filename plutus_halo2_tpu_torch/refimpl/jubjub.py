"""Jubjub — the twisted Edwards curve over the BLS12-381 scalar field — and a
Schnorr signature over it: the port's copy of
``plutus_halo2_tpu/refimpl/jubjub.py``.

This backs the ATMS (aggregate threshold multisignature) circuit family, the
native analog of the reference's atms circuits (src/circuits/atms_circuit.rs:
23-159, whose gate internals live in IOG's external atms-halo2 crate; the
statement shape — Schnorr over Jubjub inside the BLS12-381 scalar field with a
Rescue PK commitment and public inputs (pks_comm, msg, threshold) — is
reproduced here natively).

Curve: a*u^2 + v^2 = 1 + d*u^2*v^2 over F_q (q = BLS12-381 Fr), a = -1,
d = -(10240/10241). a is a square and d a non-square mod q, so the Edwards
addition law is complete — the same property the batch verifiers rely on for
branch-free G1 formulas.
"""

from __future__ import annotations

import hashlib

from .field import Q, fr_inv

A = Q - 1  # a = -1
D = (Q - 10240) * fr_inv(10241) % Q

# prime subgroup order and cofactor (Jubjub standard parameters)
ORDER = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
COFACTOR = 8
assert ORDER * COFACTOR * 2 != Q  # sanity: distinct primes

IDENTITY = (0, 1)


def is_on_curve(p) -> bool:
    u, v = p
    return (A * u * u + v * v) % Q == (1 + D * u * u % Q * v % Q * v) % Q


def add(p, q):
    """Complete twisted Edwards addition."""
    x1, y1 = p
    x2, y2 = q
    t = D * x1 % Q * x2 % Q * y1 % Q * y2 % Q
    x3 = (x1 * y2 + y1 * x2) % Q * fr_inv((1 + t) % Q) % Q
    y3 = (y1 * y2 - A * x1 % Q * x2) % Q * fr_inv((1 - t) % Q) % Q
    return (x3, y3)


def neg(p):
    return ((Q - p[0]) % Q, p[1])


def mul(p, k: int):
    acc = IDENTITY
    base = p
    k %= ORDER
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


def _sqrt_fr(x: int):
    """Tonelli-Shanks over Fr (2-adicity 32)."""
    if x == 0:
        return 0
    if pow(x, (Q - 1) // 2, Q) != 1:
        return None
    # Q - 1 = t * 2^32 with t odd
    s, t = 32, (Q - 1) >> 32
    z = 5  # known non-residue mod Q (generator of the 2-Sylow path)
    while pow(z, (Q - 1) // 2, Q) == 1:
        z += 1
    m, c, r, tt = s, pow(z, t, Q), pow(x, (t + 1) // 2, Q), pow(x, t, Q)
    while tt != 1:
        i, tmp = 0, tt
        while tmp != 1:
            tmp = tmp * tmp % Q
            i += 1
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        r, tt = r * b % Q, tt * c % Q
    return r


def _derive_generator():
    """Deterministic prime-order generator: smallest u whose v is a square,
    cofactor-cleared."""
    u = 1
    while True:
        num = (1 + u * u) % Q
        den = (1 - D * u % Q * u) % Q
        if den != 0:
            v2 = num * fr_inv(den) % Q
            v = _sqrt_fr(v2)
            if v is not None:
                p = (u, min(v, Q - v))
                if is_on_curve(p):
                    g = mul(p, COFACTOR)
                    if g != IDENTITY and mul(g, ORDER) == IDENTITY:
                        return g
        u += 1


GEN = _derive_generator()


# ---------------------------------------------------------------------------
# Schnorr over Jubjub (host-side reference; the circuit re-verifies this)
# ---------------------------------------------------------------------------

def _h_scalar(*parts: bytes) -> int:
    h = hashlib.blake2b(b"".join(parts), digest_size=64).digest()
    return int.from_bytes(h, "little") % ORDER


def keygen(seed: bytes):
    sk = _h_scalar(b"jubjub-sk", seed)
    if sk == 0:
        sk = 1
    return sk, mul(GEN, sk)


def sign(sk: int, msg_fr: int, challenge_hash, seed: bytes = b""):
    """Deterministic Schnorr: R = k*G, c = challenge_hash(R.u, PK.u, msg) mod
    order, s = k + c*sk. challenge_hash: callable [Fr] -> Fr (Rescue sponge —
    the same function the circuit evaluates)."""
    pk = mul(GEN, sk)
    k = _h_scalar(b"jubjub-nonce", sk.to_bytes(32, "little"), msg_fr.to_bytes(32, "little"), seed)
    if k == 0:
        k = 1
    R = mul(GEN, k)
    c = challenge_hash([R[0], pk[0], msg_fr]) % ORDER
    s = (k + c * sk) % ORDER
    return (R, s)


def verify(pk, msg_fr: int, sig, challenge_hash) -> bool:
    R, s = sig
    if not (is_on_curve(R) and is_on_curve(pk)):
        return False
    c = challenge_hash([R[0], pk[0], msg_fr]) % ORDER
    return mul(GEN, s) == add(R, mul(pk, c))
