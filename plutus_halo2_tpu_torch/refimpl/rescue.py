"""Rescue-Prime sponge over the BLS12-381 scalar field: the port's copy of
``plutus_halo2_tpu/refimpl/rescue.py``.

Host-side reference for the PK-commitment / Schnorr-challenge hash of the
ATMS circuit family (the reference delegates to RescueSponge in its external
atms-halo2 crate, src/circuits/atms_circuit.rs:141-144; the construction is
standard Rescue-Prime, the concrete constants here are framework-defined and
derived deterministically from a domain tag).

Parameters: state width m = 3 (rate 2, capacity 1), alpha = 5 (the smallest
odd integer coprime to q-1), N = 7 rounds, each round = S-box x^alpha ->
MDS+constants -> inverse S-box x^(1/alpha) -> MDS+constants. The inverse
S-box is what the circuit verifies cheaply: witness y, constrain y^5 = x.
"""

from __future__ import annotations

import hashlib
import math

from .field import Q

M = 3  # state width
RATE = 2
ROUNDS = 7

ALPHA = 5
assert math.gcd(ALPHA, Q - 1) == 1
ALPHA_INV = pow(ALPHA, -1, Q - 1)

# MDS: small circulant matrix, verified MDS (all minors nonsingular) below
MDS = [[2, 1, 1], [1, 2, 1], [1, 1, 2]]


def _assert_mds(m):
    import itertools

    n = len(m)
    for size in range(1, n + 1):
        for rows in itertools.combinations(range(n), size):
            for cols in itertools.combinations(range(n), size):
                sub = [[m[r][c] for c in cols] for r in rows]
                if size == 1:
                    det = sub[0][0]
                elif size == 2:
                    det = sub[0][0] * sub[1][1] - sub[0][1] * sub[1][0]
                else:
                    det = (
                        sub[0][0] * (sub[1][1] * sub[2][2] - sub[1][2] * sub[2][1])
                        - sub[0][1] * (sub[1][0] * sub[2][2] - sub[1][2] * sub[2][0])
                        + sub[0][2] * (sub[1][0] * sub[2][1] - sub[1][1] * sub[2][0])
                    )
                assert det % Q != 0, f"MDS violated at {rows}x{cols}"


_assert_mds(MDS)


def _round_constants():
    out = []
    for i in range(2 * ROUNDS * M):
        h = hashlib.blake2b(
            b"plutus-halo2-tpu/rescue/rc/" + i.to_bytes(4, "little"), digest_size=64
        ).digest()
        out.append(int.from_bytes(h, "little") % Q)
    return out


RC = _round_constants()


def _linear(state, rc_off):
    return [
        (sum(MDS[i][j] * state[j] for j in range(M)) + RC[rc_off + i]) % Q
        for i in range(M)
    ]


def permute(state):
    """The Rescue-Prime permutation on an M-element Fr state."""
    s = list(state)
    for r in range(ROUNDS):
        s = [pow(x, ALPHA, Q) for x in s]
        s = _linear(s, 2 * r * M)
        s = [pow(x, ALPHA_INV, Q) for x in s]
        s = _linear(s, (2 * r + 1) * M)
    return s


def hash_fr(inputs):
    """Sponge with rate 2, capacity 1; 10* padding; returns one Fr element."""
    buf = list(inputs) + [1]
    while len(buf) % RATE:
        buf.append(0)
    state = [0] * M
    for i in range(0, len(buf), RATE):
        for j in range(RATE):
            state[j] = (state[j] + buf[i + j]) % Q
        state = permute(state)
    return state[0]
