"""Batched Blake2b-256 in PyTorch: the port of ``plutus_halo2_tpu/ops/blake2b.py``.

The hash behind the reference's Fiat-Shamir transcript (Transcript.hs:85-88,
transcript.ak:80-90). 64-bit words are (lo, hi) pairs of 32-bit values held
in int64 tensors, as in the JAX package; every shift is masked back to 32
bits. The 16-word state is processed as four 4-word quarters (a column step,
then a diagonal step on rotated quarters), so each round is two vectorised
G steps instead of eight. Message lengths are static per call site (the
transcript layout of a circuit is static); batch dims broadcast."""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
IV_LO = np.array([v & M32 for v in _IV], dtype=np.int64)
IV_HI = np.array([v >> 32 for v in _IV], dtype=np.int64)
# h0 = IV with the parameter block (digest length 32, fanout 1, depth 1)
# folded into word 0
H0_LO = IV_LO.copy()
H0_LO[0] ^= 0x01010020
H0_HI = IV_HI.copy()

SIGMA = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
        [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
        [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
        [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
        [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
        [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
        [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
        [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
        [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    ],
    dtype=np.int64,
)
SIGMA12 = np.concatenate([SIGMA, SIGMA[:2]], axis=0)  # 12 rounds
# per round, the message words of the column step (x, y) and the diagonal
# step (x, y), each 4 wide
_MSG_IDX = np.stack(
    [
        np.stack([SIGMA12[r, 0:8:2], SIGMA12[r, 1:8:2], SIGMA12[r, 8:16:2], SIGMA12[r, 9:16:2]])
        for r in range(12)
    ]
)  # (12, 4, 4)


def _add(a, b):
    lo = a[0] + b[0]
    return (lo & M32, (a[1] + b[1] + (lo >> 32)) & M32)


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _ror(a, r: int):
    lo, hi = a
    if r == 32:
        return (hi, lo)
    if r > 32:
        lo, hi = hi, lo
        r -= 32
    return (
        (lo >> r) | ((hi << (32 - r)) & M32),
        (hi >> r) | ((lo << (32 - r)) & M32),
    )


def _rot(x, k: int):
    """Rotate a (lo, hi) pair of (..., 4) quarters left by k words."""
    return (torch.roll(x[0], -k, dims=-1), torch.roll(x[1], -k, dims=-1))


def _g4(a, b, c, d, mx, my):
    a = _add(_add(a, b), mx)
    d = _ror(_xor(d, a), 32)
    c = _add(c, d)
    b = _ror(_xor(b, c), 24)
    a = _add(_add(a, b), my)
    d = _ror(_xor(d, a), 16)
    c = _add(c, d)
    b = _ror(_xor(b, c), 63)
    return a, b, c, d


def compress(h_lo, h_hi, m_lo, m_hi, t, final: bool):
    """One Blake2b compression. h: (..., 8) lo/hi words; m: (..., 16) message
    words; t: byte counter (int or (...,) tensor, < 2^32); final: last-block
    flag. Returns the new (h_lo, h_hi)."""
    dev = m_lo.device
    shape = torch.broadcast_shapes(h_lo.shape[:-1], m_lo.shape[:-1])
    iv_lo = torch.as_tensor(IV_LO, device=dev)
    iv_hi = torch.as_tensor(IV_HI, device=dev)
    a = (h_lo[..., 0:4].expand(*shape, 4), h_hi[..., 0:4].expand(*shape, 4))
    b = (h_lo[..., 4:8].expand(*shape, 4), h_hi[..., 4:8].expand(*shape, 4))
    c = (iv_lo[0:4].expand(*shape, 4), iv_hi[0:4].expand(*shape, 4))
    # d = IV[4:8] ^ (t, 0, f, 0)
    dx = torch.zeros((*shape, 4), dtype=torch.int64, device=dev)
    dx[..., 0] = torch.as_tensor(t, dtype=torch.int64, device=dev)
    if final:
        dx[..., 2] = M32
    fx = torch.zeros_like(dx)
    if final:
        fx[..., 2] = M32
    d = (iv_lo[4:8] ^ dx, iv_hi[4:8] ^ fx)
    idx = torch.as_tensor(_MSG_IDX, device=dev)
    for r in range(12):
        msg = [(m_lo[..., idx[r, k]], m_hi[..., idx[r, k]]) for k in range(4)]
        a, b, c, d = _g4(a, b, c, d, msg[0], msg[1])
        b, c, d = _rot(b, 1), _rot(c, 2), _rot(d, 3)
        a, b, c, d = _g4(a, b, c, d, msg[2], msg[3])
        b, c, d = _rot(b, 3), _rot(c, 2), _rot(d, 1)
    v_lo = torch.cat([a[0], b[0]], -1) ^ torch.cat([c[0], d[0]], -1)
    v_hi = torch.cat([a[1], b[1]], -1) ^ torch.cat([c[1], d[1]], -1)
    return h_lo ^ v_lo, h_hi ^ v_hi


def bytes_to_words(b):
    """(..., 8n) uint8 -> (lo, hi) each (..., n) int64 LE64 words."""
    w = b.reshape(*b.shape[:-1], -1, 8).to(torch.int64)
    lo = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    hi = w[..., 4] | (w[..., 5] << 8) | (w[..., 6] << 16) | (w[..., 7] << 24)
    return lo, hi


def digest_words(h_lo, h_hi):
    """State -> the 32-byte digest as (..., 8) words (lo0, hi0, lo1, ...)."""
    return torch.stack([h_lo[..., :4], h_hi[..., :4]], -1).reshape(*h_lo.shape[:-1], 8)


def words_to_bytes(w):
    """(..., 8) LE64 (lo, hi) words -> (..., 32) uint8."""
    sh = torch.arange(0, 32, 8, device=w.device)
    return ((w.unsqueeze(-1) >> sh) & 0xFF).reshape(*w.shape[:-1], 32).to(torch.uint8)


def _h0(shape, device):
    return (
        torch.as_tensor(H0_LO, device=device).expand(*shape, 8),
        torch.as_tensor(H0_HI, device=device).expand(*shape, 8),
    )


def blake2b_256_words(msg):
    """msg: (..., MLEN) uint8 with static MLEN -> (..., 8) digest words."""
    mlen = msg.shape[-1]
    nblocks = max(1, -(-mlen // 128))
    pad = nblocks * 128 - mlen
    if pad:
        msg = torch.nn.functional.pad(msg, (0, pad))
    lo, hi = bytes_to_words(msg)
    lo = lo.reshape(*msg.shape[:-1], nblocks, 16)
    hi = hi.reshape(*msg.shape[:-1], nblocks, 16)
    h = _h0(msg.shape[:-1], msg.device)
    for i in range(nblocks):
        h = compress(h[0], h[1], lo[..., i, :], hi[..., i, :],
                     min((i + 1) * 128, mlen), i == nblocks - 1)
    return digest_words(*h)


def blake2b_256(msg):
    """msg: (..., MLEN) uint8 -> (..., 32) uint8 digest."""
    return words_to_bytes(blake2b_256_words(msg))


def blake2b_256_prefixes_words(buf, lengths):
    """Hash S nested prefixes buf[..., :l] of ONE buffer in a single chained
    pass: all full 128-byte blocks share the running state, and each prefix
    costs one extra final-block compression (batched over S).

    buf: (..., TOTAL) uint8; lengths: static list of S prefix lengths >= 1.
    Returns (..., S, 8) digest words."""
    S = len(lengths)
    batch = buf.shape[:-1]
    dev = buf.device
    fbs = [(l - 1) // 128 for l in lengths]  # final-block index per prefix
    max_fb = max(fbs)
    need = (max_fb + 1) * 128
    if need > buf.shape[-1]:
        buf = torch.nn.functional.pad(buf, (0, need - buf.shape[-1]))
    lo, hi = bytes_to_words(buf[..., :need])
    lo = lo.reshape(*batch, max_fb + 1, 16)
    hi = hi.reshape(*batch, max_fb + 1, 16)

    # states[j] = state after compressing blocks 0..j-1 as non-final blocks
    states = [_h0(batch, dev)]
    for j in range(max_fb):
        h = states[-1]
        states.append(compress(h[0], h[1], lo[..., j, :], hi[..., j, :], (j + 1) * 128, False))

    # one batched final compression over the S prefixes; final-block bytes at
    # or past each prefix's length are zero
    mask = np.zeros((S, 128), dtype=np.uint8)
    for s, l in enumerate(lengths):
        mask[s, : l - fbs[s] * 128] = 1
    fin = torch.stack([buf[..., fb * 128 : (fb + 1) * 128] for fb in fbs], -2)
    fin = fin * torch.as_tensor(mask, device=dev)
    flo, fhi = bytes_to_words(fin)  # (..., S, 16)
    h_lo = torch.stack([states[fb][0] for fb in fbs], -2)
    h_hi = torch.stack([states[fb][1] for fb in fbs], -2)
    t = torch.as_tensor(list(lengths), dtype=torch.int64, device=dev)
    return digest_words(*compress(h_lo, h_hi, flo, fhi, t, True))


def blake2b_256_prefixes(buf, lengths):
    """(..., TOTAL) uint8 -> (..., S, 32) uint8 prefix digests."""
    return words_to_bytes(blake2b_256_prefixes_words(buf, lengths))
