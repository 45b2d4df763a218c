"""Transcript kernel (``csrc/blake2b.cu``), its plain PyTorch version and its
launch counter.

Replaces ``plutus_halo2_tpu/ops/pallas_blake.py:82`` ``make_transcript_kernel``:
for every proof row, Blake2b-256 of every squeeze prefix of the transcript
buffer (h1) and of each 32-byte h1 (h2), as (B, S, 8) LE64 (lo, hi) words
held in int64. The plain version is the JAX package's XLA path ported:
``blake2b_256_prefixes`` followed by ``blake2b_256``.

The kernel runs a compression on a group of lanes (``B2_LANES`` in
``csrc/blake2b.cu``, fixed by its launcher), a row's squeezes side by side
on groups (one a squeeze, fewer where a block's threads run out: then the
squeezes take rounds), and the fewest rows a block that put every row in
one wave of blocks (fewer where the rows' bytes would not fit in shared
memory)."""

from __future__ import annotations

import torch

from . import _build
from .blake2b import blake2b_256_prefixes_words, blake2b_256_words, words_to_bytes

# the squeeze lengths on the card, then the squeezes in the order of their
# final blocks (the kernel's chain keeps their states in that order), per
# (lengths, device): copied once, not on every call
_LENS: dict = {}


def transcript_hashes_plain(buf, lengths):
    h1 = blake2b_256_prefixes_words(buf, lengths)
    return h1, blake2b_256_words(words_to_bytes(h1))


def _lens_on(lengths: tuple, device) -> torch.Tensor:
    key = (lengths, str(device))
    t = _LENS.get(key)
    if t is None:
        order = sorted(range(len(lengths)), key=lambda s: ((lengths[s] - 1) // 128, s))
        t = _LENS[key] = torch.tensor(lengths + tuple(order), dtype=torch.int32, device=device)
    return t


def transcript_hashes(buf, lengths):
    """buf (B, TOTAL) uint8 -> (h1, h2) each (B, S, 8) int64 digest words;
    h1[:, s] hashes buf[:, :lengths[s]], h2[:, s] hashes h1[:, s]."""
    if buf.device.type == "cpu":
        return transcript_hashes_plain(buf, lengths)
    _build.require(buf, "buf", torch.uint8, (None, None))
    lengths = tuple(int(n) for n in lengths)
    if not lengths or min(lengths) < 1:
        raise ValueError("squeeze lengths must be >= 1")
    B, T = buf.shape
    S = len(lengths)
    max_fb = max((n - 1) // 128 for n in lengths)
    h1 = torch.empty((B, S, 8), dtype=torch.int64, device=buf.device)
    h2 = torch.empty_like(h1)
    lib = _build.library()
    _build.check(lib.ph2_transcript(_build.ptr(buf), B, T, _build.ptr(_lens_on(lengths, buf.device)), S, max_fb,
                                    _build.ptr(h1), _build.ptr(h2), _build.stream_ptr()),
                 "ph2_transcript")
    transcript_hashes.launches += 1
    return h1, h2


transcript_hashes.launches = 0
