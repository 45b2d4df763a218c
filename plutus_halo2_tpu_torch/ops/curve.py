"""Batched BLS12-381 G1 arithmetic in PyTorch: the port of
``plutus_halo2_tpu/ops/curve.py``.

Points are homogeneous projective (X:Y:Z) over Montgomery-form Fp limbs,
shape (..., 3, L). All formulas are the complete a=0 formulas of
Renes-Costello-Batina 2015 (Algorithms 7 and 9): branch-free and
identity-safe. The independent field multiplies of each formula run as one
stacked call, so a point add costs four batched Montgomery products.

``msm`` (per-point 4-bit windows over a 16-entry table, then one halving
tree over K: the JAX package's ``jc.msm``) is the second reference of the
MSM kernel (``csrc/msm.cu``); ``msm_windowed`` is its plain version, the
kernel's decomposition step for step (signed windows, a table of multiples
per point, window sums over the row's points, one doubling chain per row),
whose limbs the kernel's equal. ``aggregate_subgroup_check`` (the JAX
package's algorithm) is the plain version of the subgroup kernel
(``csrc/subgroup.cu``) on the CPU route; ``aggregate_subgroup_check_windowed``
(the same decomposition over the weights' 3-bit windows) is the plain
version of that kernel's decomposition, and with ``decompress(...,
y_hint=)`` of the hinted decompression kernel (``csrc/decompress.cu``).
``decompress`` without a hint is the plain version of the hintless
decompression kernel (``csrc/sqrt_decode.cu``).
"""

from __future__ import annotations

import secrets
from typing import NamedTuple

import numpy as np
import torch

from ..refimpl.field import BLS_X, P
from . import limb
from .limb import FP_SPEC, FR_SPEC, fp

_B3 = FP_SPEC.to_mont(12)  # 3*b, b = 4
_B = FP_SPEC.to_mont(4)


_CONSTS: dict = {}


def _c(arr, device):
    """A module constant on `device`, copied there once (a copy inside a
    captured program would read host memory at capture time only)."""
    key = (arr.tobytes(), arr.shape, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, device=device)
    return t


def pt(x, y, z):
    return torch.stack([x, y, z], -2)


def identity(shape, device):
    """(0 : 1 : 0)."""
    return pt(fp.zeros(shape, device), fp.one(shape, device), fp.zeros(shape, device))


def host_point_to_mont(p) -> np.ndarray:
    """Host-side: affine int point (or None) -> (3, L) Montgomery projective."""
    if p is None:
        return np.stack([FP_SPEC.to_mont(0), FP_SPEC.to_mont(1), FP_SPEC.to_mont(0)])
    x, y = p
    return np.stack([FP_SPEC.to_mont(x), FP_SPEC.to_mont(y), FP_SPEC.to_mont(1)])


def host_point_from_mont(arr) -> tuple | None:
    """Host-side: (3, L) Montgomery projective -> affine int point / None."""
    arr = np.asarray(arr)
    x = FP_SPEC.from_mont_int(arr[0])
    y = FP_SPEC.from_mont_int(arr[1])
    z = FP_SPEC.from_mont_int(arr[2])
    if z == 0:
        return None
    zi = pow(z, FP_SPEC.N - 2, FP_SPEC.N)
    return (x * zi % FP_SPEC.N, y * zi % FP_SPEC.N)


def add(p, q):
    """Complete addition, RCB15 Algorithm 7 (a=0)."""
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p.unbind(-2)
    X2, Y2, Z2 = q.unbind(-2)
    b3 = _c(_B3, p.device)
    t0, t1, t2 = fp.mul(p, q).unbind(-2)
    s = fp.add(torch.stack([X1, X2, Y1, Y2, X1, X2], -2),
               torch.stack([Y1, Y2, Z1, Z2, Z1, Z2], -2))
    m = fp.mul(s[..., 0::2, :], s[..., 1::2, :])
    u = fp.add(torch.stack([t0, t1, t0], -2), torch.stack([t1, t2, t2], -2))
    t3, t4, y3 = fp.sub(m, u).unbind(-2)
    t0 = fp.add(fp.add(t0, t0), t0)
    t2, y3 = fp.mul(torch.stack([t2, y3], -2), b3).unbind(-2)
    z3 = fp.add(t1, t2)
    t1 = fp.sub(t1, t2)
    pr = fp.mul(torch.stack([t4, t3, y3, t1, t0, z3], -2),
                torch.stack([y3, t1, t0, z3, t3, t4], -2))
    x3 = fp.sub(pr[..., 1, :], pr[..., 0, :])
    yz = fp.add(pr[..., 3:6:2, :], pr[..., 2:5:2, :])  # (t1 z3 + y3 t0, z3 t4 + t0 t3)
    return torch.stack([x3, yz[..., 0, :], yz[..., 1, :]], -2)


def double(p):
    """Complete doubling, RCB15 Algorithm 9 (a=0)."""
    X, Y, Z = p.unbind(-2)
    b3 = _c(_B3, p.device)
    t0, t1, t2, xy = fp.mul(torch.stack([Y, Y, Z, X], -2), torch.stack([Y, Z, Z, Y], -2)).unbind(-2)
    t2 = fp.mul(t2, b3)
    a1 = fp.add(torch.stack([t0, t2], -2), torch.stack([t0, t2], -2))  # 2 t0, 2 t2
    a2 = fp.add(a1, torch.stack([a1[..., 0, :], t2], -2))  # 4 t0, 3 t2
    a3 = fp.add(torch.stack([a2[..., 0, :], t0], -2), torch.stack([a2[..., 0, :], t2], -2))
    z8, y3 = a3.unbind(-2)  # 8 t0, t0 + t2
    t0 = fp.sub(t0, a2[..., 1, :])
    pr = fp.mul(torch.stack([t2, t1, t0, t0], -2), torch.stack([z8, z8, y3, xy], -2))
    out = fp.add(pr[..., 0:4:3, :], pr[..., 2:4, :])  # (t2 z8 + t0 y3, 2 t0 xy)
    return torch.stack([out[..., 1, :], out[..., 0, :], pr[..., 1, :]], -2)


def neg(p):
    return pt(p[..., 0, :], fp.neg(p[..., 1, :]), p[..., 2, :])


def select(cond, p, q):
    """cond (...,) -> pointwise select."""
    return torch.where(cond[..., None, None], p, q)


def is_identity(p):
    return fp.is_zero(p[..., 2, :])


def eq(p, q):
    """Projective equality: cross-multiplied affine comparison, identity-aware."""
    X1, Y1, Z1 = p.unbind(-2)
    X2, Y2, Z2 = q.unbind(-2)
    x1z2, x2z1, y1z2, y2z1 = fp.mul(torch.stack(torch.broadcast_tensors(X1, X2, Y1, Y2), -2),
                                    torch.stack(torch.broadcast_tensors(Z2, Z1, Z2, Z1), -2)).unbind(-2)
    inf_p, inf_q = is_identity(p), is_identity(q)
    both_fin = fp.eq(x1z2, x2z1) & fp.eq(y1z2, y2z1) & ~inf_p & ~inf_q
    return both_fin | (inf_p & inf_q)


def _nibbles_msb_first(scalars):
    """(..., L_fr) 16-bit limbs -> (64, ...) window values, MSB window first.
    Canonical Fr fits 255 bits, so windows beyond 64 are always zero."""
    sh = torch.arange(0, 16, 4, device=scalars.device)
    nib = ((scalars.unsqueeze(-1) >> sh) & 0xF).reshape(*scalars.shape[:-1], -1)[..., :64]
    return torch.movedim(nib.flip(-1), -1, 0)


def _window_table(p):
    """[0*P, 1*P, ..., 15*P] stacked on a new dim -3: (..., 16, 3, L)."""
    tab = [identity(p.shape[:-2], p.device), p]
    for _ in range(14):
        tab.append(add(tab[-1], p))
    return torch.stack(tab, -3)


def mul(p, scalars, nwin: int = 64):
    """Batched scalar multiplication: p (..., 3, L) by canonical Fr limbs
    (..., L_fr) below 2^(4 nwin). The windows above those are all zero and
    leave the accumulator at exactly (0 : 1 : 0), so skipping them changes
    no limb of the result."""
    table = _window_table(p)
    windows = _nibbles_msb_first(scalars)[64 - nwin :]
    acc = identity(p.shape[:-2], p.device)
    for w in windows:
        acc = double(double(double(double(acc))))
        idx = w[..., None, None, None].expand(*w.shape, 1, 3, table.shape[-1])
        acc = add(acc, table.gather(-3, idx).squeeze(-3))
    return acc


def tree_sum(points):
    """Point sum over dim -3 by halving tree: log2(K) add layers."""
    t = points
    k = t.shape[-3]
    while k > 1:
        half = k // 2
        paired = add(t[..., :half, :, :], t[..., half : 2 * half, :, :])
        if k % 2:
            paired = torch.cat([paired, t[..., 2 * half : k, :, :]], -3)
            half += 1
        t = paired
        k = half
    return t[..., 0, :, :]


def msm(points, scalars, nwin: int = 64):
    """Batched multi-scalar multiplication over a static K dim:
    points (..., K, 3, L), scalars (..., K, L_fr) canonical -> (..., 3, L)."""
    return tree_sum(mul(points, scalars, nwin))


# ---------------------------------------------------------------------------
# the MSM kernel's decomposition (csrc/msm.cu, group.cuh)
# ---------------------------------------------------------------------------

MSM_NWIN = {4: 64, 5: 52}  # signed windows of 4 / 5 bits over a 256-bit scalar


def signed_recode(raw, half: int):
    """Signed digits of window values raw (..., NWIN), LSB window first:
    d = raw + carry, and d > half becomes d - 2 half with a carry into the
    next window. The caller's top window must not carry."""
    out, carry = [], torch.zeros_like(raw[..., 0])
    for w in range(raw.shape[-1]):
        d = raw[..., w] + carry
        carry = (d > half).to(d.dtype)
        out.append(d - 2 * half * carry)
    return torch.stack(out, -1)


def scalar_digits(scalars, wbits: int):
    """(..., L_fr) canonical Fr limbs -> (..., NWIN) signed digits of wbits
    bits, in [-2^(wbits-1), 2^(wbits-1)], LSB window first (the scalars are
    below 2^255, so the top window never carries)."""
    pos = torch.arange(MSM_NWIN[wbits], device=scalars.device) * wbits
    lim = torch.nn.functional.pad(scalars, (0, 1))
    two = lim[..., pos // 16] | (lim[..., pos // 16 + 1] << 16)
    return signed_recode((two >> (pos % 16)) & ((1 << wbits) - 1), 1 << (wbits - 1))


def multiples_table(p, half: int):
    """(..., 3, L) -> (..., half, 3, L): the multiples 1 P .. half P, entry e
    the sum of entries ceil(e/2) and floor(e/2) (the kernels build them in
    levels of independent additions)."""
    tab = [None, p]
    for e in range(2, half + 1):
        tab.append(add(tab[(e + 1) // 2], tab[e // 2]))
    return torch.stack(tab[1:], -3)


def window_sums(tab, digits):
    """tab (..., K, half, 3, L), digits (..., K, J) -> (..., J, 3, L): for
    each job j the sum over k in order of d tab[k, |d|] with d =
    digits[k, j], from the identity, nothing added for d = 0."""
    J = digits.shape[-1]
    wsum = identity((*digits.shape[:-2], J), tab.device)
    for k in range(digits.shape[-2]):
        d = digits[..., k, :]
        idx = (d.abs() - 1).clamp(min=0)
        tab_k = tab[..., k, :, :, :]
        sel = tab_k.gather(-3, idx[..., None, None].expand(*idx.shape, 3, tab.shape[-1]))
        sel = select(d < 0, neg(sel), sel)
        wsum = select(d != 0, add(wsum, sel), wsum)
    return wsum


def window_chain(wsum, wbits: int):
    """(..., NWIN, 3, L) window sums -> (..., 3, L): sum_w 2^(wbits w)
    wsum[w] by one doubling chain, MSB window first, from the top window's
    sum."""
    acc = wsum[..., -1, :, :]
    for w in range(wsum.shape[-3] - 2, -1, -1):
        for _ in range(wbits):
            acc = double(acc)
        acc = add(acc, wsum[..., w, :, :])
    return acc


def msm_windowed(points, scalars, wbits: int = 5):
    """Batched MSM by the MSM kernel's decomposition: points (..., K, 3, L),
    scalars (..., K, L_fr) canonical -> (..., 3, L), the kernel's limbs."""
    tab = multiples_table(points, 1 << (wbits - 1))
    return window_chain(window_sums(tab, scalar_digits(scalars, wbits)), wbits)


def to_affine(p):
    """(..., 3, L) projective -> (x, y, inf): Montgomery affine coordinates
    (zero for the identity) and the identity flag."""
    inf = is_identity(p)
    zi = fp.inv(p[..., 2, :])
    xy = fp.mul(p[..., 0:2, :], zi.unsqueeze(-2))
    return xy[..., 0, :], xy[..., 1, :], inf


# ---------------------------------------------------------------------------
# subgroup membership (ops/curve.py:248-360 of the JAX package)
# ---------------------------------------------------------------------------
# The reference's bls12_381_G1_uncompress rejects points outside the q-order
# subgroup G1. Criterion (Bowe 2019 / Scott 2021): P in G1 <=> phi(P) ==
# [z^2 - 1] P, phi(x, y) = (beta x, y), z the BLS parameter and beta the
# cube root of unity paired with lambda = z^2 - 1.

def _derive_beta() -> int:
    b = 2
    while True:
        c = pow(b, (P - 1) // 3, P)
        if c != 1:
            return pow(c, 2, P)  # the root paired with lambda = z^2 - 1
        b += 1


BETA = _derive_beta()
_BETA_MONT = FP_SPEC.to_mont(BETA)
_ZBITS = [int(c) for c in bin(BLS_X)[2:]]  # |z| MSB first


def _mul_by_z_abs(p):
    """[|z|]P by double-and-add over the static 64-bit pattern (the JAX
    package's scan computes the add at every bit and selects it at the set
    ones; adding only there gives the same limbs)."""
    acc = identity(p.shape[:-2], p.device)
    for bit in _ZBITS:
        acc = double(acc)
        if bit:
            acc = add(acc, p)
    return acc


def subgroup_check(p):
    """(..., 3, L) projective Montgomery points -> (...,) bool: q-order
    subgroup membership (the identity counts as a member)."""
    t = _mul_by_z_abs(_mul_by_z_abs(p))  # [z^2]P (the sign squares away)
    rhs = add(t, neg(p))  # [z^2 - 1]P
    phi_p = pt(fp.mul(p[..., 0, :], _c(_BETA_MONT, p.device)), p[..., 1, :], p[..., 2, :])
    return eq(phi_p, rhs) | is_identity(p)


# The aggregate form: each row's points are summed with verifier-chosen
# weights and only the aggregate is tested. Honest rows always pass; a row
# holding non-subgroup points evades one round with probability <= 1/3 over
# the weights (the order-3 factor of the G1 cofactor binds), `rounds`
# independent rounds with <= 3^-rounds. The verification equation itself is
# cofactor-insensitive, so only byte-level accept parity with the
# reference's uncompress abort is at stake.
SUBGROUP_WEIGHT_BITS = 16  # [1, 2^16) is exactly uniform mod 3
DEFAULT_SUBGROUP_ROUNDS = 1  # the one default of every aggregate-mode surface


def subgroup_weights(n_points: int, rounds: int = DEFAULT_SUBGROUP_ROUNDS,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Fresh verifier-side aggregation weights: (rounds, n_points) int64 on
    the CPU, uniform in [1, 2^SUBGROUP_WEIGHT_BITS), shared by every row of
    a batch. From `generator` when given, else from the OS's randomness."""
    hi = 1 << SUBGROUP_WEIGHT_BITS
    if generator is not None:
        return torch.randint(1, hi, (rounds, n_points), generator=generator, dtype=torch.int64)
    return torch.tensor([[1 + secrets.randbelow(hi - 1) for _ in range(n_points)]
                         for _ in range(rounds)], dtype=torch.int64).reshape(rounds, n_points)


class CheckedWeights(NamedTuple):
    """Aggregation weights that ``check_weights`` has already held to
    [1, 2^16): a (rounds, n_points) int32 tensor on their device, which no
    call reads back (a captured program's static weights buffer)."""

    w: torch.Tensor


def check_weights(weights, n_points: int) -> torch.Tensor:
    """Aggregation weights as a (rounds, n_points) int64 CPU tensor, each in
    [1, 2^16); raises on anything else (both the kernel and its plain
    version take only such weights). CheckedWeights are checked by shape
    only and stay on their device."""
    if isinstance(weights, CheckedWeights):
        if weights.w.dim() != 2 or weights.w.shape[1] != n_points:
            raise ValueError(f"weights must be (rounds >= 1, {n_points}), got {tuple(weights.w.shape)}")
        return weights.w.to(torch.int64)
    w = torch.as_tensor(weights).cpu()
    if w.dtype.is_floating_point or w.dtype == torch.bool or w.dim() != 2 \
            or w.shape[0] < 1 or w.shape[1] != n_points:
        raise ValueError(f"weights must be (rounds >= 1, {n_points}) integers, got "
                         f"{tuple(w.shape)} {w.dtype}")
    w = w.to(torch.int64)
    if bool(((w < 1) | (w >= 1 << SUBGROUP_WEIGHT_BITS)).any()):
        raise ValueError(f"weights must lie in [1, 2^{SUBGROUP_WEIGHT_BITS})")
    return w


def aggregate_subgroup_check(pts, weights):
    """pts (B, K, 3, L) projective Montgomery, weights (rounds, K) in
    [1, 2^16) -> (B,) bool: per-row aggregate membership over all rounds.
    The weights go through the generic MSM as Fr limbs (4 windows cover
    them), as the JAX package's aggregate_subgroup_check does."""
    w = check_weights(weights, pts.shape[-3]).to(pts.device)
    w_limbs = torch.nn.functional.pad(torch.stack([w & limb.MASK16, w >> 16], -1),
                                      (0, FR_SPEC.L - 2))
    ok = None
    for r in range(w.shape[0]):
        q = msm(pts, w_limbs[r].expand(*pts.shape[:-2], FR_SPEC.L), nwin=4)
        ok_r = subgroup_check(q)
        ok = ok_r if ok is None else ok & ok_r
    return ok


AGG_WBITS, AGG_NWIN = 3, 6  # signed 3-bit windows of a weight < 2^16 (the top one never carries)


def aggregate_subgroup_check_windowed(pts, weights):
    """The subgroup and fused decompress kernels' aggregate test, as ``aggregate_subgroup_check``
    but by its decomposition: per round, the weights' signed 3-bit windows
    over the tables [1P..4P], the window sums over the row's points, one
    chain of 3 doublings a window; then the endomorphism test of each
    aggregate. pts (B, K, 3, L), weights (rounds, K) -> (B,) bool."""
    B, K = pts.shape[:2]
    w = check_weights(weights, K).to(pts.device)
    R = w.shape[0]
    shifts = torch.arange(AGG_NWIN, device=pts.device) * AGG_WBITS
    dig = signed_recode((w[..., None] >> shifts) & ((1 << AGG_WBITS) - 1), 1 << (AGG_WBITS - 1))
    digits = dig.permute(1, 0, 2).reshape(K, R * AGG_NWIN).expand(B, K, R * AGG_NWIN)
    wsum = window_sums(multiples_table(pts, 1 << (AGG_WBITS - 1)), digits)
    q = window_chain(wsum.reshape(B, R, AGG_NWIN, 3, pts.shape[-1]), AGG_WBITS)
    return subgroup_check(q).all(-1)


# ---------------------------------------------------------------------------
# compressed-point decoding (blst conventions, CompressUncompress.hs:51-97)
# ---------------------------------------------------------------------------

def _bytes_be_to_limbs(b):
    """(..., 48) uint8 big-endian -> (..., 25) 16-bit limbs little-endian."""
    le = b.flip(-1).to(torch.int64).reshape(*b.shape[:-1], 24, 2)
    return torch.nn.functional.pad(le[..., 0] | (le[..., 1] << 8), (0, 1))


def decompress(comp_bytes, y_hint=None):
    """Batched G1 decompression: (..., 48) uint8 -> (point (..., 3, L),
    valid (...,) bool). Invalid encodings yield valid=False (the caller folds
    this into the verdict; the on-chain builtin would abort the script).
    Without a hint the root is the x^((p+1)/4) ladder.

    y_hint optionally supplies an UNTRUSTED candidate root ((..., L) 16-bit
    limbs, e.g. from TorchVerifier.compute_y_hints): the y^2 == x^3 + 4
    check rejects non-roots and the sign logic normalizes whichever root was
    given, so a wrong hint can only reject. The hint is read mod 2^384 (its
    low 24 limbs, each mod 2^16), as the hinted decompression kernel reads
    it (the JAX package's make_decompress_kernel does the same). This
    differs from the JAX package's jc.decompress, which reads all 25 limbs,
    only for a hint >= 2^384; such a hint is never a canonical root, and
    both readings stay sound: a truncated hint is a root only if it is the
    true one."""
    flags = comp_bytes[..., 0].to(torch.int64)
    comp_flag = (flags & 0x80) != 0
    inf_flag = (flags & 0x40) != 0
    sign_flag = (flags & 0x20) != 0

    x_bytes = comp_bytes.clone()
    x_bytes[..., 0] = (flags & 0x1F).to(torch.uint8)
    x_limbs = _bytes_be_to_limbs(x_bytes)
    dev = x_limbs.device
    # x < p: x + (R - p) overflows R iff x >= p
    z = limb.normalize(torch.nn.functional.pad(x_limbs, (0, 1)) + FP_SPEC.const("neg_n_ext", dev), 18)
    x_ge_p = z[..., -1] > 0

    xm = fp.to_mont(x_limbs)
    rhs = fp.add(fp.mul(fp.mul(xm, xm), xm), _c(_B, dev))
    if y_hint is not None:
        hint = torch.as_tensor(y_hint, device=dev).to(torch.int64)[..., :24] & limb.MASK16
        y = fp.to_mont(torch.nn.functional.pad(hint, (0, 1)))
    else:
        y = fp.pow(rhs, (FP_SPEC.N + 1) >> 2)
    root_ok = fp.eq(fp.mul(y, y), rhs)

    # sign: y > -y in the integer sense — compare canonical (non-Montgomery)
    y_neg = fp.neg(y)
    y_int, ny_int = fp.from_mont(torch.stack([y, y_neg])).unbind(0)
    # ny + (R - y) overflows R iff ny >= y
    diff = limb.normalize(
        torch.nn.functional.pad(y_int + (limb.MASK16 - ny_int), (0, 1))
        + torch.nn.functional.pad(FP_SPEC.const("unit", dev), (0, 1)),
        18,
    )
    y_gt = (diff[..., -1] > 0) & ~fp.eq(y_int, ny_int)

    want_neg = sign_flag != y_gt
    y_final = limb.select(want_neg, y_neg, y)

    point = pt(xm, y_final, fp.one(xm.shape[:-1], dev))
    ident = identity(point.shape[:-2], dev)
    # infinity: flags 0xc0 with zero payload
    rest_zero = (x_bytes[..., 1:] == 0).all(-1) & ((flags & 0x1F) == 0)
    inf_ok = inf_flag & ~sign_flag & rest_zero
    point = select(inf_flag, ident, point)
    valid = comp_flag & torch.where(inf_flag, inf_ok, root_ok & ~x_ge_p)
    return point, valid
