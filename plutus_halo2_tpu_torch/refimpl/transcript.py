"""Cardano-friendly Blake2b-256 Fiat-Shamir transcript (executable spec): the
port's copy of ``plutus_halo2_tpu/refimpl/transcript.py``: the verifier's
``Transcript`` and the prover's ``ProverTranscript``.

Bit-exact reimplementation of the reference's transcript semantics, defined in
three equivalent places:
  - Rust `CardanoFriendlyBlake2b` (src/plutus_gen/adjusted_types/mod.rs:26-57)
  - Plinth `Transcript.hs:64-102` + `ApplicativeParser.hs:33-96`
  - Aiken `lib/transcript.ak:10-98`

State = the full accumulated byte string (re-hashed on every squeeze).
Absorb scalar:  state || 0x01 || LE32(s)
Absorb point:   state || 0x01 || compressed48(P)
Squeeze:        h1 = blake2b256(state || 0x00); h2 = blake2b256(h1);
                challenge = (LE(h1) + 2^256 * LE(h2)) mod q;
                new state = state || 0x00
Run is seeded by absorbing vk.transcript_repr as a scalar.
"""

from __future__ import annotations

import hashlib

from .field import Q, fr_from_le_bytes, fr_to_le_bytes
from .curve import g1_compress, g1_decompress

PREFIX_CHALLENGE = b"\x00"
PREFIX_COMMON = b"\x01"


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


class Transcript:
    """Verifier-side transcript walking a proof byte string.

    Mirrors the reference's `ApplicativeParser` state = (remaining proof,
    accumulated transcript bytes)."""

    def __init__(self, proof: bytes, transcript_repr: int):
        self.proof = proof
        self.cursor = 0
        self.acc = bytearray()
        self.common_scalar(transcript_repr)

    # -- absorb-only (public inputs, vk repr) --------------------------------
    def common_scalar(self, s: int) -> int:
        self.acc += PREFIX_COMMON + fr_to_le_bytes(s)
        return s % Q

    # -- proof reads (absorb as they are read) -------------------------------
    def read_scalar(self) -> int:
        raw = self._take(32)
        self.acc += PREFIX_COMMON + raw
        return fr_from_le_bytes(raw)

    def read_point(self):
        raw = self._take(48)
        self.acc += PREFIX_COMMON + raw
        return g1_decompress(raw)

    def _take(self, n: int) -> bytes:
        if self.cursor + n > len(self.proof):
            raise ValueError("not enough bytes to read")  # Proof.hs:46 guard
        out = self.proof[self.cursor : self.cursor + n]
        self.cursor += n
        return out

    # -- challenges ----------------------------------------------------------
    def squeeze_challenge(self) -> int:
        data = bytes(self.acc) + PREFIX_CHALLENGE
        h1 = blake2b_256(data)
        h2 = blake2b_256(h1)
        self.acc += PREFIX_CHALLENGE
        return (int.from_bytes(h1, "little") + (int.from_bytes(h2, "little") << 256)) % Q



class ProverTranscript:
    """Prover-side transcript: writes proof bytes while absorbing them,
    with identical challenge derivation. Role of the Rust
    `CircuitTranscript<CardanoFriendlyBlake2b>` used by the reference examples
    (examples/simple_mul.rs:100-108)."""

    def __init__(self, transcript_repr: int):
        self.acc = bytearray()
        self.proof = bytearray()
        self.common_scalar(transcript_repr)

    def common_scalar(self, s: int):
        self.acc += PREFIX_COMMON + fr_to_le_bytes(s)

    def write_scalar(self, s: int):
        raw = fr_to_le_bytes(s)
        self.proof += raw
        self.acc += PREFIX_COMMON + raw

    def write_point(self, p):
        raw = g1_compress(p)
        self.proof += raw
        self.acc += PREFIX_COMMON + raw

    def squeeze_challenge(self) -> int:
        data = bytes(self.acc) + PREFIX_CHALLENGE
        h1 = blake2b_256(data)
        h2 = blake2b_256(h1)
        self.acc += PREFIX_CHALLENGE
        return (int.from_bytes(h1, "little") + (int.from_bytes(h2, "little") << 256)) % Q

    def finalize(self) -> bytes:
        return bytes(self.proof)
