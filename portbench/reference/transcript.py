"""The verifier's Blake2b transcript (the benchmark's frozen copy of
``plutus_halo2_tpu_torch/refimpl/transcript.py``'s ``Transcript``).

Mirrors the reference's ``ApplicativeParser`` state: the remaining proof
and the accumulated transcript bytes."""

from __future__ import annotations

import hashlib

from .curve import g1_decompress
from .field import Q, fr_from_le_bytes, fr_to_le_bytes

PREFIX_CHALLENGE = b"\x00"
PREFIX_COMMON = b"\x01"


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


class Transcript:
    """Verifier-side transcript walking a proof byte string."""

    def __init__(self, proof: bytes, transcript_repr: int):
        self.proof = proof
        self.cursor = 0
        self.acc = bytearray()
        self.common_scalar(transcript_repr)

    def common_scalar(self, s: int) -> int:
        self.acc += PREFIX_COMMON + fr_to_le_bytes(s)
        return s % Q

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
        out = self.proof[self.cursor: self.cursor + n]
        self.cursor += n
        return out

    def squeeze_challenge(self) -> int:
        data = bytes(self.acc) + PREFIX_CHALLENGE
        h1 = blake2b_256(data)
        h2 = blake2b_256(h1)
        self.acc += PREFIX_CHALLENGE
        return (int.from_bytes(h1, "little") + (int.from_bytes(h2, "little") << 256)) % Q
