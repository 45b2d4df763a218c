"""The yardstick of the kernels' roofline shares: the card's peaks and the
work a batch's inputs need, counted with the cheapest algorithm the
repository has for each function, never with a kernel's own.

The peaks and the counting functions are copies of ``chip_smoke.py``'s
(``INT32_OPS_PER_S``, ``HBM_BYTES_PER_S``, ``_bound_ms``, ``_cios_products``,
``_pairing_ops``, ``_signed_digits``, ``_msm_fp_products``,
``_sub_digits``, ``_aggregate_fp_products``), kept here so that a change to
the program cannot move them. ``batch_work`` applies them to one batch:
rows, live points and MSM terms come from the benchmark's own reference
(``reference/verifier.py``) on each distinct input of the batch, and from
the batch's own RLC weights.

Peaks of one H100 SXM: HBM 3.35e12 B/s (NVIDIA's data sheet); 32-bit
integer operations 132 SMs x 64 lanes x 1.98e9 Hz = 1.67e13/s, derived
from the SM count and boost clock of the published FP32 rate (128 FP32
lanes an SM) with half its lanes, the integer multiply-add rate of compute
capability 9.0 (CUDA C++ Programming Guide). Both hold at the card's full
power limit of 700 W; every run prints the card's limit beside them."""

from __future__ import annotations

from dataclasses import dataclass

from .reference.field import BLS_X
from .reference.verifier import DECODE, EQUATION

INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# the least bytes an implementation moves: a G1 point as affine x, y (2 x 48
# bytes), a scalar as 32 bytes, a projective result as 3 x 48, a verdict 1
POINT_BYTES, SCALAR_BYTES, RESULT_BYTES, VERDICT_BYTES = 96, 32, 144, 1


def _bound_ms(int_ops: float, nbytes: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_ops = int_ops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cios_products(nw: int) -> int:
    """32x32 word products of one CIOS Montgomery product."""
    return 2 * nw * nw + nw


FP2_MUL = 3  # Karatsuba
FP12_MUL = 18 * FP2_MUL  # Karatsuba over Fp6 (pallas_pairing.py:234)
FP12_SQR = 12 * FP2_MUL  # complex squaring over Fp6 (:266)
CYC_SQR = 9 * 2  # Granger-Scott, 9 Fp2 squarings of 2 products (:280)
LINE = 2 + 13 * FP2_MUL  # lambda * x, then the sparse 0/2/3 product (:324)
FROB = 6 * FP2_MUL

# An Fp inversion by the binary extended Euclidean algorithm: at least
# log2(p) halvings of u or v, each a 12-word shift and a 12-word add
FP_INV_OPS = 381 * 2 * 12 * 2


def _pairing_ops(n_live: int, x_abs: int) -> int:
    """32-bit integer operations of one pairing-check row with n_live
    non-identity points (x_abs: |BLS x|): its Fp products, each a CIOS
    product of word multiplies counted as two operations, and its
    inversions."""
    if n_live == 0:
        return 0  # e(O, Q1) e(O, Q2) = 1: nothing to compute
    n_sq, n_add = x_abs.bit_length() - 1, bin(x_abs).count("1") - 1
    affine = n_live * 2
    miller = (n_sq - 1) * FP12_SQR + n_live * (n_sq + n_add) * LINE  # f = 1 needs no first squaring
    fp6_inv = 12 * FP2_MUL + 4
    fp12_inv = 24 * FP2_MUL + fp6_inv
    easy = fp12_inv + FP12_MUL + FROB + FP12_MUL
    exp_by_x = n_sq * CYC_SQR + n_add * FP12_MUL
    hard = 5 * exp_by_x + 2 * FP12_MUL + (FROB + FP12_MUL) + (FROB + 2 * FP12_MUL) + (CYC_SQR + 2 * FP12_MUL)
    products = affine + miller + easy + hard
    return 2 * products * _cios_products(12) + (n_live + 1) * FP_INV_OPS


def _signed_digits(s: int, nwin: int = 52) -> list[int]:
    """Magnitudes of the signed 5-bit window digits of s (LSB window first)."""
    out, carry = [], 0
    for w in range(nwin):
        d = ((s >> (5 * w)) & 31) + carry
        carry = int(d > 16)
        out.append(32 - d if carry else d)
    return out


def _msm_fp_products(scalars: list[int], live: list[bool]) -> int:
    """Fp products of one MSM row: per live term (non-zero scalar,
    non-identity point) a 15-add table; per window the adds of its non-zero
    digits into the window sum (the first is a copy); one shared chain of 5
    doublings per window below the top non-zero one, and the adds that fold
    the non-empty window sums into it. RCB15: add 12, double 8 products."""
    nwin = 52
    count = [0] * nwin
    terms = 0
    for s, ok in zip(scalars, live):
        if ok and s:
            terms += 1
            for w, m in enumerate(_signed_digits(s, nwin)):
                count[w] += m != 0
    nonempty = [w for w in range(nwin) if count[w]]
    if not nonempty:
        return 0
    top = max(nonempty)
    adds = 15 * terms + sum(c - 1 for c in count if c) + (len(nonempty) - 1)
    return 12 * adds + 8 * 5 * top


SUB_WBITS, SUB_NWIN = 3, 6  # the aggregate test's signed windows of a weight < 2^16
Z_LADDERS = 2 * (63 * 8 + 5 * 12) + 12 + 5  # [z^2 - 1]Q and the endomorphism comparison


def _sub_digits(w: int) -> list[int]:
    """Magnitudes of the signed 3-bit window digits of a weight < 2^16."""
    out, carry = [], 0
    for i in range(SUB_NWIN):
        d = ((w >> (SUB_WBITS * i)) & 7) + carry
        carry = int(d > 4)
        out.append(8 - d if carry else d)
    return out


def _aggregate_fp_products(weights, live: list[bool]) -> int:
    """Fp products of one row's aggregate subgroup test: per round, a 3-add
    table per live (non-identity) point, per window the adds of its non-zero
    digits into the window sum, a shared chain of 3 doublings per window
    below the top non-empty one and the adds folding the window sums into
    it; then two 64-bit z-ladders (63 doublings and 5 adds each), one add
    and 5 products comparing phi(Q) with [z^2 - 1]Q."""
    terms = sum(live)
    if not terms:
        return 0  # the identity aggregate is a member: nothing to compute
    total = 0
    for w_r in weights:
        count = [0] * SUB_NWIN
        for w, ok in zip(w_r, live):
            if ok:
                for i, m in enumerate(_sub_digits(int(w))):
                    count[i] += m != 0
        nonempty = [i for i in range(SUB_NWIN) if count[i]]
        adds = 3 * terms + sum(c - 1 for c in count if c) + len(nonempty) - 1
        total += 12 * adds + 8 * SUB_WBITS * max(nonempty) + Z_LADDERS
    return total


# --- one batch's work --------------------------------------------------------

@dataclass
class Work:
    """The operations and bytes one batch's inputs need of a kernel."""

    ops: int = 0
    nbytes: int = 0

    def add(self, ops: int, nbytes: int):
        self.ops += ops
        self.nbytes += nbytes

    def bound_ms(self) -> tuple[float, str]:
        return _bound_ms(self.ops, self.nbytes)


def _pairing_row(n_live: int) -> tuple[int, int]:
    return _pairing_ops(n_live, BLS_X), 2 * POINT_BYTES + VERDICT_BYTES


def _msm_row(scalars: list[int], live: list[bool]) -> tuple[int, int]:
    k = sum(1 for s, ok in zip(scalars, live) if ok and s)
    return 2 * _msm_fp_products(scalars, live) * _cios_products(12), k * (POINT_BYTES + SCALAR_BYTES) + RESULT_BYTES


def _live(o) -> int:
    return (o.el is not None) + (o.er is not None)


def batch_work(entry: str, rows, outcomes, rlc_weights=None, group: int | None = None) -> dict:
    """{"pairing": Work, "msm": Work} of one batch: rows[i] indexes
    `outcomes` (the reference's Outcome of each distinct input).

    A row the reference rejects while decoding needs no pairing and no MSM.
    Every other row needs its multi-open MSMs over the reference's merged
    terms. ``verify``: one pairing check a decoded row, over its live
    points. ``verify_rlc_device``: the aggregation MSM, one row a group and
    side over the group's weights (0 for a row rejected while decoding) and
    live points, one pairing check a group over the live aggregates, and
    one a decoded row of every group that holds a row whose equation
    fails."""
    rows = [int(r) for r in rows]
    pairing, msm = Work(), Work()
    decoded = [outcomes[r].stage != DECODE for r in rows]
    per_input = {}  # a distinct input's multi-open MSM rows, counted once
    for r in set(rows):
        w = Work()
        for terms in outcomes[r].msms:
            w.add(*_msm_row([s for s, _ in terms], [True] * len(terms)))
        per_input[r] = w
    for r, ok in zip(rows, decoded):
        if ok:
            msm.add(per_input[r].ops, per_input[r].nbytes)
    if entry == "verify":
        for r, ok in zip(rows, decoded):
            if ok:
                pairing.add(*_pairing_row(_live(outcomes[r])))
        return {"pairing": pairing, "msm": msm}
    if entry != "verify_rlc_device":
        raise ValueError(f"no work count for entry {entry!r}")
    weights = [sum(int(v) << (16 * i) for i, v in enumerate(w)) for w in rlc_weights]
    for g in range(0, len(rows), group):
        members = range(g, g + group)
        sc = [weights[i] if decoded[i] else 0 for i in members]
        for side in ("el", "er"):
            msm.add(*_msm_row(sc, [getattr(outcomes[rows[i]], side) is not None for i in members]))
        live = sum(any(sc[j] and getattr(outcomes[rows[i]], side) is not None for j, i in enumerate(members))
                   for side in ("el", "er"))
        pairing.add(*_pairing_row(live))
        if any(outcomes[rows[i]].stage == EQUATION for i in members):
            for i in members:
                if decoded[i]:
                    pairing.add(*_pairing_row(_live(outcomes[rows[i]])))
    return {"pairing": pairing, "msm": msm}


def share(ctx, kernel: str, work: str, label: str):
    """A kernel's roofline share in %, over the traced sub-window of a run
    context (run.Context): the least time of the traced batches' `work`
    ("pairing" or "msm", batch_work's) over the device time of the kernels
    whose name holds `kernel`; None where nothing was traced or ran. Notes
    which bound binds."""
    if ctx.trace is None:
        return None
    device_us = sum(d for n, _s, d in ctx.trace.kernels if kernel in n)
    if device_us <= 0:
        return None
    total = Work()
    for li in ctx.trace.layouts:
        w = ctx.work[li][work]
        total.add(w.ops, w.nbytes)
    least_ms, bound = total.bound_ms()
    if least_ms <= 0:
        return None
    n = ctx.trace.batches
    ctx.note(f"[roofline] {label}: {total.ops / n:.6g} int32 ops and {total.nbytes / n:.6g} bytes a batch, "
             f"least {least_ms / n:.6f} ms by {bound}, device {device_us / 1e3 / n:.6f} ms a batch")
    return 100.0 * least_ms / (device_us / 1e3)
