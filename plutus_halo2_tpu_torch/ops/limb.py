"""Batched multi-precision modular arithmetic in PyTorch.

The port of ``plutus_halo2_tpu/ops/limb.py``. Field elements are int64
tensors (..., L) of 16-bit limbs, little-endian, canonical (value < N), in the
Montgomery domain for multiplication chains — the same limbs, the same
R = 2^(16 L) (L = 17 for Fr, 25 for Fp) and the same canonical results as the
JAX package, so every intermediate compares limb for limb.

Every op is a handful of whole-tensor torch ops, batched over any leading
dims (no per-limb Python loop):

  - products: one outer product plus a skewed row sum gives the column sums
    (each < 2^42, exact in int64);
  - carries: value-preserving 16-bit folds until every column is <= 2^16,
    then an exact carry-lookahead done as one integer addition of packed
    generate/propagate bit vectors (2L+2 <= 62 columns fit one int64);
  - Montgomery: separated-operand reduction m = (T mod R) N' mod R,
    T' = (T + m N) / R, with the conditional subtraction of N resolved in
    the same carry pass as T' (both candidates normalised side by side).

These are the plain versions of the CUDA kernels in ``csrc/``. On the card
the verifier's hot stages run as kernels, and so does every op of ``fr``
(``FrField``: one launch of ``csrc/fr_glue.cu`` an op, ``ops/cuda_fr.py``);
the functions here stay the CPU path, the tests' reference and the Fp
path. ``mont_mul``, ``add`` and ``sub`` count the Fr calls that reach them
with a CUDA tensor (``cuda_fr.plain_on_cuda``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..refimpl.field import P, Q
from . import cuda_fr

MASK16 = 0xFFFF


def int_to_limbs(x: int, L: int) -> np.ndarray:
    if x < 0 or x >> (16 * L):
        raise ValueError("value does not fit limb count")
    return np.array([(x >> (16 * i)) & 0xFFFF for i in range(L)], dtype=np.int64)


def limbs_to_int(a) -> int:
    a = np.asarray(a)
    return sum(int(v) << (16 * i) for i, v in enumerate(a.reshape(-1)))


def window_digits(exponent: int) -> list[int]:
    """MSB-first 4-bit window digits of a static exponent (the port of
    ``plutus_halo2_tpu/ops/pallas_core.py:385``)."""
    bits = bin(exponent)[2:]
    bits = bits.zfill(-(-len(bits) // 4) * 4)
    return [int(bits[k : k + 4], 2) for k in range(0, len(bits), 4)]


class FieldSpec:
    """Precomputed constants for one prime field. R = 2^(16 L) with
    N < R / 2^17, the margin the lazy-sum helpers rely on."""

    def __init__(self, modulus: int, limbs: int, name: str):
        self.N = modulus
        self.L = limbs
        self.name = name
        R = 1 << (16 * limbs)
        if (modulus << 17) >= R:
            raise ValueError("need N/R <= 2^-17 margin")
        self.R = R
        self.R_mod = R % modulus
        self.R2_mod = (R * R) % modulus
        self.N_inv_neg = (-pow(modulus, -1, R)) % R  # N' with N*N' = -1 mod R
        self.n_limbs = int_to_limbs(modulus, limbs)
        self.nprime_limbs = int_to_limbs(self.N_inv_neg, limbs)
        self.neg_n_limbs = int_to_limbs(R - modulus, limbs)
        self.one_mont = int_to_limbs(self.R_mod, limbs)
        self.r2_limbs = int_to_limbs(self.R2_mod, limbs)
        # (2^(16(L+1)) - N) at limbs L..2L of a 2L+2-column product: adding it
        # tests T' >= N in the same carry pass that normalises T'
        csub = np.zeros(2 * limbs + 2, dtype=np.int64)
        csub[limbs : 2 * limbs + 1] = int_to_limbs((1 << (16 * (limbs + 1))) - modulus, limbs + 1)
        self._host = {
            "n": self.n_limbs,
            "nprime": self.nprime_limbs,
            "neg_n_ext": np.concatenate([self.neg_n_limbs, [0]]),
            "n_ext": np.concatenate([self.n_limbs, [0]]),
            "one_mont": self.one_mont,
            "r2": self.r2_limbs,
            "csub": csub,
            "unit": int_to_limbs(1, limbs),
            "zero": int_to_limbs(0, limbs),
        }
        self._dev: dict = {}

    def const(self, name: str, device) -> torch.Tensor:
        """A constant limb vector as an int64 tensor on `device` (cached)."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(self._host[name], dtype=torch.int64, device=device)
            self._dev[key] = t
        return t

    # -- host-side conversions ------------------------------------------------
    def to_mont(self, x: int) -> np.ndarray:
        return int_to_limbs((x % self.N) * self.R_mod % self.N, self.L)

    def from_mont_int(self, limbs) -> int:
        v = limbs_to_int(limbs)
        return v * pow(self.R_mod, -1, self.N) % self.N

    def encode(self, x: int) -> np.ndarray:
        """Canonical (non-Montgomery) limb encoding."""
        return int_to_limbs(x % self.N, self.L)


FR_SPEC = FieldSpec(Q, 17, "fr")
FP_SPEC = FieldSpec(P, 25, "fp")


# ---------------------------------------------------------------------------
# carry machinery
# ---------------------------------------------------------------------------

def _fold_rounds(bound_bits: int) -> int:
    """Value-preserving 16-bit folds needed before every column of magnitude
    < 2^bound_bits is <= 2^16 (so carries are 0/1)."""
    m, n = (1 << bound_bits) - 1, 0
    while m > 0x10000:
        m = MASK16 + (m >> 16)
        n += 1
    return n


def _lazy_round(cols):
    """One fold of 16-bit carries into the next column (carry out of the top
    column is dropped; callers size the column count so the value fits)."""
    return (cols & MASK16) + F.pad((cols >> 16)[..., :-1], (1, 0))


_POS: dict = {}


def _positions(K: int, device) -> torch.Tensor:
    key = (K, str(device))
    t = _POS.get(key)
    if t is None:
        t = torch.arange(K, dtype=torch.int64, device=device)
        _POS[key] = t
    return t


def normalize(cols, bound_bits: int = 42):
    """Exact carry resolution of (..., K) non-negative columns, each
    < 2^bound_bits, into canonical 16-bit limbs (top carry dropped; K <= 62).

    After the folds every column is <= 2^16, so column k generates a carry
    iff it equals 2^16 and propagates one iff it equals 2^16 - 1. Packing the
    generate bits G and propagate bits P into one int64 each, the carry into
    every column falls out of a single addition: x = G|P, y = G, carry bits
    = (x + y) ^ x ^ y."""
    for _ in range(_fold_rounds(bound_bits)):
        cols = _lazy_round(cols)
    K = cols.shape[-1]
    pos = _positions(K, cols.device)
    g = ((cols >> 16) << pos).sum(-1)
    p = ((cols == MASK16).to(torch.int64) << pos).sum(-1)
    x = g | p
    c = (x + g) ^ x ^ g
    carry = (c.unsqueeze(-1) >> pos) & 1
    return (cols + carry) & MASK16


def _diag_sum(prod):
    """(..., L, M) -> (..., L+M-1): out[k] = sum_i prod[i, k-i]. Skew trick:
    pad rows to width L+M, flatten, drop the last L entries and view as rows
    of width L+M-1 — row i is then shifted right by i — and sum the rows."""
    L, M = prod.shape[-2], prod.shape[-1]
    W = L + M
    x = F.pad(prod, (0, L))
    x = x.reshape(*prod.shape[:-2], L * W)[..., : L * (W - 1)]
    return x.reshape(*prod.shape[:-2], L, W - 1).sum(-2)


# ---------------------------------------------------------------------------
# field ops (all return canonical limbs < N)
# ---------------------------------------------------------------------------

def _pick(both, flag_idx: int, L: int, k: int):
    """both (2, ..., K) normalised candidates: the low L limbs of candidate k
    where its limb flag_idx is set, else of the other candidate."""
    hit = (both[k][..., flag_idx] > 0).unsqueeze(-1)
    return torch.where(hit, both[k][..., :L], both[1 - k][..., :L])


def _count_cuda(spec: FieldSpec, a):
    if spec is FR_SPEC and a.is_cuda:
        cuda_fr.plain_on_cuda += 1


def add(spec: FieldSpec, a, b):
    _count_cuda(spec, a)
    s = F.pad(a + b, (0, 1))  # value < 2N < R
    both = torch.stack(torch.broadcast_tensors(s, s + spec.const("neg_n_ext", s.device)))
    # s + (R - N) >= R  <=>  s >= N
    return _pick(normalize(both, 19), spec.L, spec.L, 1)


def sub(spec: FieldSpec, a, b):
    _count_cuda(spec, a)
    # c = a - b + R with non-negative columns (complement of b, plus one)
    c = F.pad(a + (MASK16 - b), (0, 1)) + F.pad(spec.const("unit", a.device), (0, 1))
    both = torch.stack([c, c + spec.const("n_ext", c.device)])
    # limb L of c is 1 iff a >= b (then low limbs = a - b); else a - b + N
    return _pick(normalize(both, 19), spec.L, spec.L, 0)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a*b/R mod N of (..., L) limb tensors (limbs may be
    lazy up to ~2^16 + 2^8 as long as a*b < R*N)."""
    _count_cuda(spec, a)
    L = spec.L
    dev = a.device
    a, b = torch.broadcast_tensors(a, b)
    t = _diag_sum(a.unsqueeze(-1) * b.unsqueeze(-2))  # (..., 2L-1) cols < 2^40
    # m = (T mod R) * N' mod R; only the low L columns of T matter
    mcols = _diag_sum(t[..., :L].unsqueeze(-1) * spec.const("nprime", dev))[..., :L]
    m = normalize(mcols, 62)
    mn = _diag_sum(m.unsqueeze(-1) * spec.const("n", dev))  # (..., 2L-1)
    S = F.pad(t + mn, (0, 3))  # 2L+2 columns; T + mN is divisible by R
    both = torch.stack([S, S + spec.const("csub", dev)])
    return _pick(normalize(both, 43)[..., L:], L + 1, L, 1)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def mont_pow_static(spec: FieldSpec, a, exponent: int, mul=None):
    """a^exponent (Montgomery domain) for a static exponent: a 4-bit fixed
    window over a 16-entry power table, MSB first — the decomposition of the
    pow kernel (``csrc/pow.cu``). `mul`: the product (a Field's; the plain
    one by default)."""
    mul = mul or (lambda x, y: mont_mul(spec, x, y))
    one = torch.broadcast_to(spec.const("one_mont", a.device), a.shape)
    if exponent == 0:
        return one.clone()
    tab = [one, a]
    for _ in range(14):
        tab.append(mul(tab[-1], a))
    digits = window_digits(exponent)
    acc = tab[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            acc = mul(acc, acc)
        acc = mul(acc, tab[d])
    return acc


def mont_inv(spec: FieldSpec, a, mul=None):
    """a^-1 via Fermat (exponent N-2)."""
    return mont_pow_static(spec, a, spec.N - 2, mul)


def to_mont(spec: FieldSpec, a):
    """Canonical limbs -> Montgomery domain (tolerates values < R)."""
    return mont_mul(spec, a, spec.const("r2", a.device))


def from_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, spec.const("unit", a.device))


def reduce_lazy(spec: FieldSpec, x):
    """Reduce a lazy limb tensor (raw sums of < 2^15 canonical elements) to
    canonical form: one Montgomery pass with b = R mod N."""
    x = _lazy_round(_lazy_round(x))
    return mont_mul(spec, x, spec.const("one_mont", x.device))


def dot_lazy(spec: FieldSpec, a, b, dim=-2):
    """Inner product over a static dim: elementwise Montgomery products, then
    a raw limb sum reduced in one Montgomery pass."""
    return reduce_lazy(spec, mont_mul(spec, a, b).sum(dim))


def sum_lazy(spec: FieldSpec, a, dim=-2):
    return reduce_lazy(spec, a.sum(dim))


def batch_inv(spec: FieldSpec, xs, dim: int = -2, inv_fn=None, mul=None):
    """Montgomery-trick batch inversion along a static dim (the reference's
    batchInverses, LagrangePolynomialEvaluation.hs:60-76) with one inversion
    at the root (`inv_fn`, e.g. the pow kernel; Fermat by default). Zero
    inputs produce zeros (callers guard). `mul`: the product (a Field's; the
    plain one by default)."""
    mul = mul or (lambda x, y: mont_mul(spec, x, y))
    xs_m = torch.movedim(xs, dim, 0)  # (K, ..., L)
    K = xs_m.shape[0]
    acc = torch.broadcast_to(spec.const("one_mont", xs.device), xs_m.shape[1:])
    prefix = []
    for k in range(K):
        prefix.append(acc)  # exclusive prefix products
        acc = mul(acc, xs_m[k])
    inv = (inv_fn or (lambda t: mont_inv(spec, t, mul)))(acc)
    out = [None] * K
    for k in range(K - 1, -1, -1):
        out[k] = mul(inv, prefix[k])
        inv = mul(inv, xs_m[k])
    return torch.movedim(torch.stack(out), 0, dim)


def is_zero(spec: FieldSpec, a):
    return (a == 0).all(-1)


def eq(spec: FieldSpec, a, b):
    return (a == b).all(-1)


def select(cond, a, b):
    """cond (...,) bool -> limbwise select between (..., L) tensors."""
    return torch.where(cond.unsqueeze(-1), a, b)


class Field:
    """Thin bound wrapper so call sites read fr.mul(a, b): the plain
    functions above (pow, inv and batch_inv over the Field's own mul)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.L = spec.L
        self._consts: dict = {}

    def add(self, a, b):
        return add(self.spec, a, b)

    def sub(self, a, b):
        return sub(self.spec, a, b)

    def neg(self, a):
        return neg(self.spec, a)

    def mul(self, a, b):
        return mont_mul(self.spec, a, b)

    def sqr(self, a):
        return mont_sqr(self.spec, a)

    def pow(self, a, e: int):
        return mont_pow_static(self.spec, a, e, self.mul)

    def inv(self, a):
        return mont_inv(self.spec, a, self.mul)

    def to_mont(self, a):
        return to_mont(self.spec, a)

    def from_mont(self, a):
        return from_mont(self.spec, a)

    def is_zero(self, a):
        return is_zero(self.spec, a)

    def eq(self, a, b):
        return eq(self.spec, a, b)

    def const(self, x: int, device):
        """Montgomery-domain constant as a tensor on `device`, copied there
        once (a captured program may not copy from the host)."""
        key = (x, str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(self.spec.to_mont(x), device=device)
        return t

    def batch_inv(self, xs, dim=-2, inv_fn=None):
        return batch_inv(self.spec, xs, dim, inv_fn=inv_fn, mul=self.mul)

    def dot_lazy(self, a, b, dim=-2):
        return dot_lazy(self.spec, a, b, dim)

    def sum_lazy(self, a, dim=-2):
        return sum_lazy(self.spec, a, dim)

    def zeros(self, shape, device):
        return torch.zeros((*shape, self.spec.L), dtype=torch.int64, device=device)

    def one(self, shape, device):
        return self.spec.const("one_mont", device).expand(*shape, self.spec.L).clone()


class FrField(Field):
    """Fr: an op on a CUDA tensor is one launch of its hand-written kernel
    (``ops/cuda_fr.py``, ``csrc/fr_glue.cu``), the same limbs as the plain
    function, which an op on a CPU tensor runs (the rule of
    ``cuda_field.fr_pow``). pow, inv and batch_inv keep their structure,
    each product a launch."""

    def add(self, a, b):
        return cuda_fr.add(a, b) if a.is_cuda else super().add(a, b)

    def sub(self, a, b):
        return cuda_fr.sub(a, b) if a.is_cuda else super().sub(a, b)

    def neg(self, a):
        return cuda_fr.sub(self.spec.const("zero", a.device), a) if a.is_cuda else super().neg(a)

    def mul(self, a, b):
        return cuda_fr.mul(a, b) if a.is_cuda else super().mul(a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        return self.mul(a, self.spec.const("r2", a.device))

    def from_mont(self, a):
        return self.mul(a, self.spec.const("unit", a.device))

    def dot_lazy(self, a, b, dim=-2):
        return cuda_fr.dot_lazy(a, b, dim) if a.is_cuda else super().dot_lazy(a, b, dim)

    def sum_lazy(self, a, dim=-2):
        return cuda_fr.sum_lazy(a, dim) if a.is_cuda else super().sum_lazy(a, dim)


fr = FrField(FR_SPEC)
fp = Field(FP_SPEC)
