"""Plain PyTorch versions of the prover's Fr polynomial kernels
(``csrc/poly.cu``, bound in ``ops/cuda_poly.py``): the in-order radix-2
NTT, the elementwise product, the scale by one scalar and the powers
weighting a_i k^i.

An array crosses as an (n, 8) int32 tensor of the canonical value's 32-bit
little-endian words (the uint32 bit patterns), as the kernels take it;
``to_words`` / ``from_words`` move Python ints in and out.

Inside, the plain versions follow the kernels' decomposition: the data
stays canonical and every constant is made Montgomery, so that one
Montgomery product a (c R) / R = a c is the product by c; the NTT's
twiddles are a table of w^e for e < n / 2, read at j n / 2^(s+1) in stage
s; the product of two arrays takes a second product by R^2. The arithmetic
is a row-wise CIOS over 9 limbs of 29 bits in int64 (R = 2^261), limb-major
(9, n), each step one fused multiply-add over a whole row block: products
stay below 2^58 and a column below 2^63. ``ops/limb.py``'s generic product
(17 limbs of 16 bits, outer products and carry-lookahead passes) is exact
too but took 20 us a product on one CPU core against 0.6 us here, and a
prover's CPU run does tens of millions of them."""

from __future__ import annotations

import numpy as np
import torch

from ..refimpl.field import Q

WORDS = 8
BITS = 29
NL = 9  # 261 bits
MASK = (1 << BITS) - 1
R = 1 << (BITS * NL)
N0 = (-pow(Q, -1, 1 << BITS)) % (1 << BITS)  # -q^-1 mod 2^29
R2 = R * R % Q


def to_words(values, device) -> torch.Tensor:
    """(n, 8) int32 words of the canonical values (each reduced mod q)."""
    buf = b"".join((v % Q).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<i4").reshape(len(values), WORDS)
    return torch.from_numpy(arr.copy()).to(device)


def from_words(t: torch.Tensor) -> list[int]:
    buf = t.cpu().numpy().astype("<i4", copy=False).tobytes()
    return [int.from_bytes(buf[32 * i: 32 * i + 32], "little") for i in range(t.shape[0])]


def scalar_words(x: int) -> np.ndarray:
    """The 8 words of one canonical scalar, as int32."""
    return np.frombuffer((x % Q).to_bytes(32, "little"), dtype="<i4").copy()


_CONST: dict = {}


def _col(x: int, device) -> torch.Tensor:
    """(9, 1) limbs of x < 2^261."""
    key = (x, str(device))
    t = _CONST.get(key)
    if t is None:
        t = torch.tensor([[(x >> (BITS * i)) & MASK] for i in range(NL)], dtype=torch.int64, device=device)
        if len(_CONST) < 4096:
            _CONST[key] = t
    return t


def _mont_const(x: int, device) -> torch.Tensor:
    return _col(x % Q * R % Q, device)


def _limbs(w: torch.Tensor) -> torch.Tensor:
    """(n, 8) int32 words -> (9, n) int64 limbs of 29 bits, the same value."""
    u = (w.to(torch.int64) & 0xFFFFFFFF).t()
    u = torch.cat([u, torch.zeros_like(u[:1])])
    rows = []
    for i in range(NL):
        wi, o = divmod(BITS * i, 32)
        x = u[wi] >> o
        if o + BITS > 32:
            x = x | (u[wi + 1] << (32 - o))
        rows.append(x & MASK)
    return torch.stack(rows)


def _words(x: torch.Tensor) -> torch.Tensor:
    """(9, n) canonical limbs -> (n, 8) int32 words."""
    x = torch.cat([x, torch.zeros_like(x[:2])])
    rows = []
    for j in range(WORDS):
        li, o = divmod(32 * j, BITS)
        w = x[li] >> o
        got = BITS - o
        k = li + 1
        while got < 32:
            w = w | (x[k] << got)
            got += BITS
            k += 1
        rows.append(w & 0xFFFFFFFF)
    w = torch.stack(rows, 1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _carry(t: torch.Tensor, lo: int, hi: int):
    """Propagate the carries of rows lo .. hi - 1 into the next row, in place."""
    for i in range(lo, hi):
        t[i + 1] += t[i] >> BITS
        t[i] &= MASK


def _q(r: torch.Tensor) -> torch.Tensor:
    return _col(Q, r.device).reshape(NL, *([1] * (r.dim() - 1)))


def _reduce_once(r: torch.Tensor) -> torch.Tensor:
    """r mod q for normalized limbs r < 2q."""
    d = r - _q(r)
    _carry(d, 0, NL - 1)  # arithmetic shifts carry the borrows
    return torch.where((d[NL - 1] < 0).unsqueeze(0), r, d)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b / R mod q of (9, ...) canonical limbs, broadcast over the
    trailing dims: the schoolbook product by rows, then 9 Montgomery digit
    steps."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = torch.zeros((2 * NL + 1, *shape), dtype=torch.int64, device=a.device)
    for i in range(NL):
        t[i: i + NL].addcmul_(b, a[i: i + 1])
    q = _col(Q, a.device).reshape(NL, *([1] * len(shape)))
    for i in range(NL):
        if i:
            t[i] += t[i - 1] >> BITS
        m = ((t[i] & MASK) * N0) & MASK
        t[i: i + NL].addcmul_(q, m.unsqueeze(0))
    t[NL] += t[NL - 1] >> BITS
    _carry(t, NL, 2 * NL)
    return _reduce_once(t[NL: 2 * NL].clone())


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    _carry(s, 0, NL - 1)
    return _reduce_once(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    _carry(d, 0, NL - 1)
    e = d + _q(d)
    _carry(e, 0, NL - 1)
    return torch.where((d[NL - 1] < 0).unsqueeze(0), e, d)


_POWERS: dict = {}
POWERS_CACHED = 1 << 16  # tables up to this length are kept (a prover reuses a few)


def powers_mont(k: int, m: int, device) -> torch.Tensor:
    """(9, m) Montgomery limbs of k^e, e < m, by doubling the table."""
    key = (k % Q, m, str(device))
    t = _POWERS.get(key)
    if t is not None:
        return t
    t = _mont_const(1, device)
    while t.shape[1] < m:
        t = torch.cat([t, mont_mul(t, _mont_const(pow(k, t.shape[1], Q), device))], 1)
    t = t[:, :m]
    if m <= POWERS_CACHED:
        if len(_POWERS) >= 32:
            _POWERS.clear()
        _POWERS[key] = t
    return t


def bitrev_index(n: int) -> np.ndarray:
    lg = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg):
        rev |= ((idx >> b) & 1) << (lg - 1 - b)
    return rev


def ntt_plain(a: torch.Tensor, omega: int) -> torch.Tensor:
    """In-order radix-2 NTT a_j -> sum_i a_i omega^(i j) of (n, 8) words,
    n a power of two: a bit-reversal gather, then each stage's n / 2
    butterflies at once (the first stage's twiddle is 1)."""
    n = a.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"ntt: n = {n} is not a power of two")
    x = _limbs(a)[:, torch.from_numpy(bitrev_index(n)).to(a.device)]
    tw = powers_mont(omega, max(n // 2, 1), a.device)
    h = 1
    while h < n:
        blk = x.reshape(NL, n // (2 * h), 2, h)
        u, v = blk[:, :, 0], blk[:, :, 1]
        if h > 1:
            v = mont_mul(v, tw[:, :: n // (2 * h)][:, :h].unsqueeze(1))
        x = torch.stack([add(u, v), sub(u, v)], 2).reshape(NL, n)
        h *= 2
    return _words(x)


def mul_array_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a_i b_i: (a b / R) R^2 / R."""
    return _words(mont_mul(mont_mul(_limbs(a), _limbs(b)), _col(R2, a.device)))


def scale_array_plain(a: torch.Tensor, k: int) -> torch.Tensor:
    return _words(mont_mul(_limbs(a), _mont_const(k, a.device)))


def powers_mul_array_plain(a: torch.Tensor, k: int) -> torch.Tensor:
    """a_i k^i."""
    return _words(mont_mul(_limbs(a), powers_mont(k, a.shape[0], a.device)))
