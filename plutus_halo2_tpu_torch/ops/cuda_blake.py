"""Transcript kernel (``csrc/blake2b.cu``), its plain PyTorch version and its
launch counter.

Replaces ``plutus_halo2_tpu/ops/pallas_blake.py:82`` ``make_transcript_kernel``:
for every proof row, Blake2b-256 of every squeeze prefix of the transcript
buffer (h1) and of each 32-byte h1 (h2), as (B, S, 8) LE64 (lo, hi) words
held in int64. The plain version is the JAX package's XLA path ported:
``blake2b_256_prefixes`` followed by ``blake2b_256``."""

from __future__ import annotations

import torch

from . import _build
from .blake2b import blake2b_256_prefixes_words, blake2b_256_words, words_to_bytes


def transcript_hashes_plain(buf, lengths):
    h1 = blake2b_256_prefixes_words(buf, lengths)
    return h1, blake2b_256_words(words_to_bytes(h1))


def transcript_hashes(buf, lengths):
    """buf (B, TOTAL) uint8 -> (h1, h2) each (B, S, 8) int64 digest words;
    h1[:, s] hashes buf[:, :lengths[s]], h2[:, s] hashes h1[:, s]."""
    if buf.device.type == "cpu":
        return transcript_hashes_plain(buf, lengths)
    _build.require(buf, "buf", torch.uint8, (None, None))
    if min(lengths) < 1:
        raise ValueError("squeeze lengths must be >= 1")
    B, T = buf.shape
    S = len(lengths)
    lens = torch.tensor(list(lengths), dtype=torch.int32, device=buf.device)
    h1 = torch.empty((B, S, 8), dtype=torch.int64, device=buf.device)
    h2 = torch.empty_like(h1)
    lib = _build.library()
    _build.check(lib.ph2_transcript(_build.ptr(buf), B, T, _build.ptr(lens), S,
                                    _build.ptr(h1), _build.ptr(h2), _build.BLOCK_THREADS,
                                    _build.stream_ptr()),
                 "ph2_transcript")
    transcript_hashes.launches += 1
    return h1, h2


transcript_hashes.launches = 0
