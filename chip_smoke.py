#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path — ``TorchVerifier.verify()`` of the simple_mul
circuit (halo2-book KZG) in its default mode (y-hints, the aggregate
subgroup test fused into hinted decompression; on the card a captured CUDA
graph per key), the modes beside it,
``verify_rlc`` and the serving loop, at the headline batch B = 1024 — the
GWC19 flavor and the lookup and ATMS circuits, and the probe path (the
tensor-core probe and the stage probe) through their hand-written CUDA
kernels, and the modules around them (the spec verifier and its traces, the
exporters, the submit tool, multi-device verification), and the proof
generators (keygen and prove over the Fr polynomial kernels), in phases:

  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit, its ECC counters and the kernel log's Xid lines (again at the end);
  2. build: nvcc builds every kernel from ``plutus_halo2_tpu_torch/csrc``,
     and the build log's registers, stack frame and spill bytes of the
     lane-group kernels (MSM, fused decompress, subgroup, pow, transcript),
     of both chains, of the Montgomery-product kernel and of the prover's
     NTT stage, product and powers kernels are printed;
  3. field: the Fp and Fr Montgomery-product test kernel against the plain
     PyTorch product on 2^16 random canonical pairs (exactly equal), the Fp
     kernel timed beside its bound; the Fr glue's kernels (``limb.fr`` on
     the card, ``csrc/fr_glue.cu``) against the plain ``limb.Field`` at the
     verifier's shapes and B = 1024 (products of broadcast operands,
     to_mont of values below 2^256, sums, differences, a slice's sum, a
     dot, the batch inversion's and a pow's chains of products; exactly
     equal, no layout copy), the product timed beside its bound; every
     verifier path below prints the glue's launches by op, its layout
     copies and its Fr ops on the plain path with a CUDA tensor, and fails
     unless the glue launched and the last two read 0;
  4. kernels: transcript (on the batch's buffers, at B = 1 and 17;
     against hashlib with 200 squeezes in
     rounds and on 40 KB and 300 KB transcripts; one compression's latency
     and the chain's floor), Fr pow, Fp pow, MSM (at 5-bit windows, at
     the stage probe's 4, and at the RLC aggregation's (B / 4, 8)), pairing,
     hinted decompression (fused with the subgroup test at 1 round, and
     unfused), hintless decompression (its flags also against the spec's
     decoder) and the aggregate subgroup test (1 and 2 rounds) against their
     plain PyTorch versions at the main path's shapes (exactly equal; the MSM
     limb for limb with the plain version of its decomposition and in affine
     coordinates with the per-point MSM; the pairing on 1024 distinct checks built from the
     slice's pairing sides, half of them true, and on the first 128 of
     them, the RLC group check's rows, and the first 64, each timed;
     decompression on the proof's
     points and crafted encodings, its subgroup verdicts on the rows whose
     points all decode, also against the per-point aggregate test; the
     subgroup kernel against the plain version of its decomposition and
     the per-point test); the
     three tensor-core probe kernels (int8 product,
     int8 and bf16 200-step chains) on the JAX probe's inputs at B = 1024
     and at B = 1, 17, 128, bit for bit, the two chains equal; each
     chain's step latency on one warp and its 200-step floor. Each kernel
     is timed by its device time (``ms``: the summed durations of its
     kernel over a ``torch.profiler`` window of calls,
     ``utils.profiling.device_ms``) and by what one call costs its caller
     (``call_ms``: CUDA events around the call, the host's path to the
     launch included), beside the least time the functions' operations
     need (the probe kernels' at the tensor cores' peak rates);
     ``torch._int_mm`` is timed beside the int8 product by the device time
     of every kernel it launches; then the MSM at the circuits' multi-open
     K = 3, 4, 17, 19, 32, 36, 38 on random points (the per-point references
     the prefix sums of one pass of products), and the fused decompress
     kernel at the proof points of simple_mul GWC19 (K = 11), lookup_table
     (15), atms_with_lookups (18) and atms_with_lookups_50_90_gwc19 (20),
     crafted as at K = 10: each against its
     plain versions on the same (B = 1024, K) tensors that are then timed
     and bounded;
  5. the paths, each on B = 1024 rows: a mixed batch of the committed
     simple_mul proof, its committed tampered twin, one bit-flipped row, one
     row with a corrupted proof scalar, one row whose first advice
     commitment is a point outside G1 and one honest row with a corrupted
     y-hint, through (a) the default mode, (b) the
     hintless aggregate mode, (c) the hintless mode with subgroup_check
     "off", (d) verify_rlc (group 8, hinted) on the mixed batch, and (e)
     verify_rlc on an honest batch, (e') with one corrupted hint. Each path's
     verdicts must equal its expected vector, and each path must launch
     every kernel it runs (counts set to 0 before the path, read after it;
     the "launches" of the kernels line sum these first calls); each RLC
     path launches the re-check's pairing, gated on the device by its
     suspect count, which must be non-zero on (d) and zero on (e), (e');
     paths (a), (b) and (e) are then timed, wall and stages, over three
     more calls in the graph form, traced (``utils/tracing.py``: the
     stages' event nodes in the key's traced program);
  5b. the circuits, each on B = 1024 rows: the committed set's honest
     proof, its invalid twin every 8th row, a corrupted proof scalar and,
     on an honest row, a corrupted y-hint (``circuit_batch``,
     ``corrupt_hint``; tests/test_torch_circuits.py holds the construction
     against the spec verifier), through (f) simple_mul GWC19 in the default
     mode, (g) its hintless aggregate mode, (h) its verify_rlc (group 8) on
     the mixed and on an honest batch, (i) lookup_table, (j) atms, (k)
     atms_with_lookups and (l) atms_228_408 (k = 22), each in the default
     mode; each path's verdicts, launches and multi-open MSM sizes are
     checked, and the transcript kernel at each set's squeeze layout and,
     on (g), the hintless decompress and the subgroup kernel at K = 11 are
     held against their plain versions on the very arguments the path gave
     them; (f), (g), (i), (j), (k) are timed as (a); then a
     VerificationService (batch 256, RLC group 8) answers 298 GWC19
     submissions;
  5c. programs: ``verify()`` and ``verify_rlc_device()`` run on the card as
     captured CUDA graphs (``models/programs.py``); on paths (a), (b),
     (c), strict (``subgroup_check="exact"``), (d), (e), (e'), (f), (g),
     (i), (j), (k) each program is replayed on alternating batches (the
     path's own, another, its own again), each call beside the eager form
     (``graphs`` off for the call) on the same batch and weights: the
     verdicts equal each other and the expected vector, the launches
     (counted through the replay accounting) equal the eager call's; the
     pairing kernel at enable 1 and 0 against its plain version at the
     re-check's 128 rows; the walls of (a), (b), (e), (f) and (j), eager
     and graph alternating, three calls each, medians side by side; each
     program's pool bytes;
  6. serving: a VerificationService (batch 1024, RLC group 8) answers 1100
     submissions, one full and one padded batch, and every future must
     resolve to its expected verdict;
  6b. spec: the port's spec verifier (``refimpl/verifier.py``) on the honest
     proof and the invalid twin of simple_mul (halo2-book and GWC19) and
     lookup_table: its verdicts and the card's ``verify()`` on the same rows
     must be [True, False], and ``diff_traces`` of its el / er against
     ``core()``'s el / -er (``tracing.device_traces``) empty on the honest
     row; one ``format_traces`` block is printed;
  6c. exporters: every committed artifact set round-trips byte for byte
     (``export_proof``, ``serialize_proof``, ``export_public_inputs``,
     ``vk_to_json(vk_from_json(t))``);
  6d. submit: ``tools.submit.main`` on the card, 12 submissions, every third
     tampered, each verdict checked (counted as a path);
  6e. mesh: on a virtual mesh of four entries of the card (every card where
     there are several), the legs of ``__graft_entry__.dryrun_multichip``,
     each counted as a path at B = 1024 with its verdicts, MSM launches and
     K checked: (1) ``data_parallel_verify`` of path (b)'s rows (1h: with
     path (a)'s y-hints, one corrupted), (2)
     ``verify_2d`` with dp 2 x mp 2 (the multi-open MSM split over mp), (3)
     lookup_table through the DP mesh; each leg's wall beside path (b)'s,
     timed in this phase; ``shard_map_msm`` over mp 2 and 4 and
     ``sharded_msm`` at K = 16, 17, 32, 36, equal in affine coordinates to
     the unsharded kernel, and the MSM kernel's device time at the mp-2
     slice beside the whole K; then ``init_distributed`` at world size 1
     (NCCL): the DP leg over the process group (its verdicts and weights
     through the group's collectives) and ``sharded_msm`` over the group's
     mesh at K = 16 and 36 (its entries in one process: no collective);
  7. the probe path, launch counts set to 0 before it and read after it:
     ``tools.mma_probe`` at B = 1024 and ``tools.perf_probe`` at B = 256 on
     the stages mul decompress sqrtp msmp msmp5 subk pairingp verifyh, each checking
     its own results, the verifyh stage traced into ``chiprun_out/``; every
     kernel must launch;
  8. trace: one default-mode ``verify()`` at B = 1024 under
     ``torch.profiler``, in the graph form and in the eager form, and the
     share of each in which the card was busy;
  9. bench: ``entry.entry()``'s step (its verdicts), ``entry.dryrun_multichip(4)``
     on the virtual mesh (all three legs, none skipped), and the port's bench
     (``plutus_halo2_tpu_torch.bench.main``) at B = 1024 with every row, its
     verdict asserts and the K = 64 MSM's parity with the plain windowed MSM;
     each row's line, then the rows as a table, and the phase's seconds; each
     counted as a path (the rows atms_50_90 and atms_with_lookups_50_90
     verify the port's committed 50-of-90 sets, k = 20); then the K = 64 MSM
     on the bench's tensors limb for limb against the plain windowed MSM,
     its device time and bound;
  10. prove: (i) the four Fr polynomial kernels of the prover
     (``csrc/poly.cu``: NTT, elementwise product, scale, powers weighting)
     against their plain versions at 2^4, 2^10, 2^16 (the 2-party ATMS
     coset domain) and 2^22 (50 of 90's) elements, exactly equal, the NTT
     also as the inverse of its omega^-1 call scaled by n^-1; each timed
     and bounded at 2^16 (the kernels line) and 2^22; (ii) keygen and
     prove on the card of simple_mul (halo2-book, the example's defaults),
     simple_mul GWC19 (``TrapdoorSRS.from_seed(b"test-srs")``),
     lookup_table, atms and atms_with_lookups (2 parties), each a counted
     path, byte for byte equal to the committed proof and VK text, with
     the seconds of each; (iii) each proof and its committed tampered twin
     through ``TorchVerifier.verify`` on the card: [True, False], counted.

Kernel times come from ``utils.profiling.device_ms``, whose windows are
held to the per-call kernel count and the CUDA-event time of the calls;
every window it refused on the way is printed with its filler count.

Prints one ``{"kernels": [...]}`` line, then the card line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

B = 1024
SEED = 20261016
# one H100 SXM: 132 SMs x 64 32-bit integer multiply-adds (or adds, logic
# ops, shifts) per clock x 1.98 GHz boost (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0); a 32x32->64
# word product is counted as two such operations (low and high halves)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# dense tensor-core peaks of one H100 SXM (NVIDIA's data sheet)
TC_INT8_OPS_PER_S = 1979e12
TC_BF16_FLOPS = 989e12
PROBE_BATCH = 256  # the stage probe's batch: the plain versions on the card are slow
RLC_ROWS = B // 8  # the group checks of verify_rlc(group=8)


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _call_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of one call of fn, recorded around it on an idle
    stream: what one call costs its caller, the host's path to each launch
    included (the plain versions' time, and a kernel's call_ms)."""
    import torch

    from plutus_halo2_tpu_torch.utils.profiling import call_ms

    return statistics.median(call_ms(fn, torch.device("cuda")) for _ in range(reps))


def _plain(fn):
    """(fn's output, its call ms): the plain version runs once, timed by
    CUDA events around that call, and the same output is checked."""
    out = []
    ms = _call_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def _times(fn, kernel, reps: int) -> tuple[float, float]:
    """(device ms, call ms) of one call of fn: the device time of the
    kernels whose name contains `kernel` (every kernel when None) over a
    profiler window of `reps` calls, and the host-inclusive call time."""
    from plutus_halo2_tpu_torch.utils.profiling import device_ms

    return device_ms(fn, None if kernel is None else [kernel], calls=reps), _call_ms(fn, reps)


def _bound_ms(int_ops: float, nbytes: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_ops = int_ops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- operations the functions need at this run's inputs -------------------
# Counted with the cheapest algorithm the repo has for each function (the
# JAX package's Pallas kernels: Karatsuba towers, cyclotomic squarings,
# sparse lines, one shared doubling chain per MSM row), never with the CUDA
# kernels' own simpler ones, and only for the work this run's data needs
# (no affine conversion or lines for an identity point, no additions for
# zero digits). Each Fp product is one CIOS Montgomery product.

def _cios_products(nw: int) -> int:
    """32x32 word products of one CIOS Montgomery product."""
    return 2 * nw * nw + nw


def _pow_products(digits) -> int:
    """Fp products of x^e by the 4-bit fixed window over e's MSB-first
    digits: 14 table products, then per later digit 4 squarings and one
    table product where the digit is not 0."""
    return 14 + sum(4 + (d != 0) for d in digits[1:])


FP2_MUL = 3  # Karatsuba
FP12_MUL = 18 * FP2_MUL  # Karatsuba over Fp6 (pallas_pairing.py:234)
FP12_SQR = 12 * FP2_MUL  # complex squaring over Fp6 (:266)
CYC_SQR = 9 * 2  # Granger-Scott, 9 Fp2 squarings of 2 products (:280)
LINE = 2 + 13 * FP2_MUL  # lambda * x, then the sparse 0/2/3 product (:324)
FROB = 6 * FP2_MUL


# An Fp inversion by the binary extended Euclidean algorithm (the pairing
# kernel's; the Pallas kernel's Fermat ladder takes ~490 products): at least
# log2(p) halvings of u or v, each a 12-word shift and a 12-word add (x1 or
# x2 halved mod p), as 32-bit integer operations
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


DECODE_FP_PRODUCTS = 8  # x and the hint to Montgomery, x^3, hint^2, canonical y, two out


def _nonsubgroup_point(P: int, in_g1) -> tuple[int, int]:
    """A valid E(Fp) point with nonzero h-torsion (outside G1)."""
    x = 100
    while True:
        rhs = (x**3 + 4) % P
        y = pow(rhs, (P + 1) >> 2, P)
        if y * y % P == rhs and not in_g1((x, y)):
            return (x, y)
        x += 1


def _blake_ops(lengths) -> int:
    comps = max((l - 1) // 128 for l in lengths) + 2 * len(lengths)
    # 96 G steps of 22 int32 ops: four 64-bit adds and four xors at 2 each,
    # the rotations by 24, 16 and 63 at 2 funnel shifts each (by 32: a swap)
    return comps * 12 * 8 * 22


def _hashlib_digests(buf, lengths):
    """(h1, h2) as the transcript kernel's (B, S, 8) LE64 (lo, hi) words, by
    the standard library's Blake2b-256."""
    import hashlib

    import numpy as np

    h1 = np.empty((buf.shape[0], len(lengths), 8), np.int64)
    h2 = np.empty_like(h1)
    for r, row in enumerate(buf):
        for i, n in enumerate(lengths):
            d = hashlib.blake2b(row[:n].tobytes(), digest_size=32).digest()
            h1[r, i] = np.frombuffer(d, "<u4")
            h2[r, i] = np.frombuffer(hashlib.blake2b(d, digest_size=32).digest(), "<u4")
    return h1, h2


# the circuits phase's mixed batches: the committed invalid twin every 8th
# row from row 3, a corrupted proof scalar on SCALAR_ROW, a corrupted y-hint
# on HINT_ROW (which only the hinted modes see)
CIRCUIT_SCALAR_ROW, CIRCUIT_HINT_ROW = 1, 7


def circuit_batch(proof, invalid, scalar_offset: int, n: int):
    """(batch (n, PLEN) uint8, expected (n,) bool): the honest proof, its
    committed invalid twin every 8th row from row 3, and on
    CIRCUIT_SCALAR_ROW the honest proof with a bit of its first scalar
    (at proof byte scalar_offset) flipped; expected is the spec verifier's
    verdict on each row."""
    import numpy as np

    batch = np.stack([proof] * n).copy()
    expected = np.ones(n, bool)
    batch[3::8] = invalid
    expected[3::8] = False
    batch[CIRCUIT_SCALAR_ROW, scalar_offset + 3] ^= 0x40
    expected[CIRCUIT_SCALAR_ROW] = False
    return batch, expected


def corrupt_hint(hints):
    """The hints with CIRCUIT_HINT_ROW's third point's hint off by one bit:
    that row then fails to decode in the hinted modes."""
    hints = hints.copy()
    hints[CIRCUIT_HINT_ROW, 2, 0] ^= 1
    return hints


def transcript_checks(buf, lengths, rng):
    """The transcript kernel beside the batch's check: at ragged B = 1 and
    17 against the plain Blake2b; with 200 squeezes (more than a row's groups: two rounds) at
    B = 1 and 17, and on long transcripts (40 KB at B = 1024: fewer rows a
    block; 300 KB at B = 3: no row's bytes fit in shared memory, every block
    read from global memory), against hashlib; then one compression's
    latency: the device time at the batch's lengths less that at the same
    lengths cut to one block (max_fb chain compressions apart, the same
    rows, groups and final phases), over max_fb; and the floor of a row's
    max_fb + 2 dependent compressions."""
    import numpy as np
    import torch

    from plutus_halo2_tpu_torch.ops import cuda_blake
    from plutus_halo2_tpu_torch.utils.profiling import device_ms

    def same(b, want1, want2):
        g1, g2 = cuda_blake.transcript_hashes(b, lengths)
        return torch.equal(g1, want1) and torch.equal(g2, want2)

    for n in (1, 17):
        b = torch.from_numpy(rng.integers(0, 256, size=(n, buf.shape[1]), dtype=np.uint8)).to(buf.device)
        if not same(b, *cuda_blake.transcript_hashes_plain(b, lengths)):
            _fail(f"transcript kernel differs from the plain Blake2b at B = {n}")
    for n, T, ls in ((1, 1500, 200), (17, 1500, 200), (1024, 40_000, 0), (3, 300_000, 0)):
        b = rng.integers(0, 256, size=(n, T), dtype=np.uint8)
        ls = tuple(int(x) for x in rng.integers(1, T + 1, size=ls)) if ls else (1, 129, T // 2, T - 1, T)
        g1, g2 = cuda_blake.transcript_hashes(torch.from_numpy(b).to(buf.device), ls)
        w1, w2 = _hashlib_digests(b, ls)
        if not (np.array_equal(g1.cpu().numpy(), w1) and np.array_equal(g2.cpu().numpy(), w2)):
            _fail(f"transcript kernel differs from hashlib's Blake2b at B = {n}, {T} bytes, {len(ls)} squeezes")
    print(f"[kernel] transcript exact at B = 1, 17; against hashlib "
          f"at 200 squeezes (in rounds), B = 1, 17, and at 40 KB (B = 1024) and 300 KB (B = 3, unstaged)")
    max_fb = max((n - 1) // 128 for n in lengths)
    t = [device_ms(lambda: cuda_blake.transcript_hashes(buf, ls), ["transcript_kernel"], calls=20)
         for ls in (lengths, [min(n, 128) for n in lengths])]
    comp_ms = (t[0] - t[1]) / max_fb
    print(f"[kernel] transcript: one compression {comp_ms * 1e3:.4f} us at {buf.shape[0]} rows "
          f"({t[0]:.4f} ms, {t[1]:.4f} with the lengths cut to 128); "
          f"chain floor {max_fb + 2} x = {(max_fb + 2) * comp_ms:.4f} ms")


# the prover's Fr polynomial kernels (csrc/poly.cu): the port of the JAX
# package's host C++ runtime, native/ph2_native.cpp (no Pallas kernel)
POLY_KERNELS = ("fr_ntt", "fr_mul_array", "fr_scale_array", "fr_powers_mul_array")
POLY_REPLACES = {"fr_ntt": ":138", "fr_mul_array": ":174", "fr_scale_array": ":183", "fr_powers_mul_array": ":191"}
FR_PRODUCT_OPS = 2 * _cios_products(8)  # 272 32-bit integer operations
PROVE_SIZES = (4, 10, 16, 22)  # log2 n of the parity checks: 2^16 the 2-party ATMS coset domain, 2^22 50 of 90's


def _rand_words(n: int, rng, dev):
    """(n, 8) int32 words of canonical values: 0, 1 and q - 1 first, then
    random ones (top word below q's, so every value is below q)."""
    import numpy as np
    import torch

    from plutus_halo2_tpu_torch.ops import poly as tpoly
    from plutus_halo2_tpu_torch.refimpl.field import Q

    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    w[:, 7] = rng.integers(0, Q >> 224, size=n, dtype=np.uint64)
    t = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
    head = tpoly.to_words([0, 1, Q - 1][:n], dev)
    t[: head.shape[0]] = head
    return t


def prove_phase(dev, rng, results, record, counters, counted, times, plain, stamp):
    """Phase 10: (i) each poly kernel against its plain version at 2^4,
    2^10, 2^16 and 2^22 elements, exactly (the NTT also as the inverse of
    its omega^-1 call, scaled), timed and bounded at 2^16 and 2^22; (ii)
    keygen and prove on the card of the five committed proofs, byte for
    byte with their VK text, each a counted path; (iii) each proof and its
    committed tampered twin through TorchVerifier.verify: [True, False]."""
    import numpy as np
    import torch

    from plutus_halo2_tpu_torch.examples.atms import MSG
    from plutus_halo2_tpu_torch.models.atms import AtmsCircuit, AtmsLookupCircuit, prepare_test_signatures
    from plutus_halo2_tpu_torch.models.circuits import LookupRangeCircuit, SimpleMulCircuit
    from plutus_halo2_tpu_torch.models.plan import FLAVOR_GWC, FLAVOR_HALO2
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier
    from plutus_halo2_tpu_torch.ops import cuda_poly
    from plutus_halo2_tpu_torch.ops import poly as tpoly
    from plutus_halo2_tpu_torch.refimpl.field import Q, fr_inv
    from plutus_halo2_tpu_torch.refimpl.keygen import keygen
    from plutus_halo2_tpu_torch.refimpl.poly import domain_omega
    from plutus_halo2_tpu_torch.refimpl.prover import prove
    from plutus_halo2_tpu_torch.refimpl.srs import TrapdoorSRS
    from plutus_halo2_tpu_torch.utils import artifacts
    from plutus_halo2_tpu_torch.utils.serialization import vk_to_json

    t10 = time.perf_counter()
    k = int.from_bytes(rng.bytes(32), "little") % Q
    fns = {
        "fr_ntt": (lambda a, b: cuda_poly.fr_ntt(a, domain_omega(a.shape[0].bit_length() - 1)),
                   lambda a, b: tpoly.ntt_plain(a, domain_omega(a.shape[0].bit_length() - 1)), "fr_"),
        "fr_mul_array": (cuda_poly.fr_mul_array, tpoly.mul_array_plain, "fr_mul_array_kernel"),
        "fr_scale_array": (lambda a, b: cuda_poly.fr_scale_array(a, k), lambda a, b: tpoly.scale_array_plain(a, k),
                           "fr_scale_kernel"),
        "fr_powers_mul_array": (lambda a, b: cuda_poly.fr_powers_mul_array(a, k),
                                lambda a, b: tpoly.powers_mul_array_plain(a, k), "fr_powers_"),
    }

    def bound(name, n):
        lg = n.bit_length() - 1
        if name == "fr_ntt":  # (n / 2) log2 n products; each word read and written once
            return _bound_ms(n // 2 * lg * FR_PRODUCT_OPS, 64 * n)
        if name == "fr_mul_array":
            return _bound_ms(n * FR_PRODUCT_OPS, 96 * n)
        if name == "fr_scale_array":
            return _bound_ms(n * FR_PRODUCT_OPS, 64 * n + 32)
        return _bound_ms(2 * n * FR_PRODUCT_OPS, 64 * n + 32)  # k^i by a running product, then a_i k^i

    for lg in PROVE_SIZES:
        n = 1 << lg
        a, b = _rand_words(n, rng, dev), _rand_words(n, rng, dev)
        for name, (kern, plain_fn, kname) in fns.items():
            got = kern(a, b)
            want, plain_ms = plain(lambda: plain_fn(a, b))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).any(-1).sum())
                _fail(f"{name} kernel differs from its plain version on {bad} of {n} elements")
            if name == "fr_ntt":
                w = domain_omega(lg)
                back = cuda_poly.fr_scale_array(cuda_poly.fr_ntt(got, fr_inv(w)), fr_inv(n))
                if not torch.equal(back, a):
                    _fail(f"fr_ntt at 2^{lg}: the scaled omega^-1 transform is not its inverse")
            if lg < 16:
                continue
            (ms, call), bd = times(lambda: kern(a, b), kname, 10), bound(name, n)
            print(f"[prove] {name} at 2^{lg}: {ms:.4f} ms device, {call:.4f} ms per call, plain {plain_ms:.3f} ms, "
                  f"bound {bd[0]:.5f} ms by {bd[1]} (ratio {ms / bd[0]:.1f})")
            if lg == 16:  # the kernels line: the 2-party ATMS coset domain, the paths' largest
                record(name, "plutus_halo2_tpu_torch/csrc/poly.cu",
                       "plutus_halo2_tpu/native/ph2_native.cpp" + POLY_REPLACES[name], 0, (ms, call), plain_ms, bd)
        print(f"[prove] poly kernels exact at n = 2^{lg} against their plain versions (the NTT also inverted)")
    for name in POLY_KERNELS:
        results[name]["launches"] = 0
        counters[name] = getattr(cuda_poly, name)
    stamp("prove phase: kernels")

    # (ii) keygen and prove on the card, against the committed bytes
    pks, sigs, _comm = prepare_test_signatures(2, 1, MSG)
    cases = (  # name, circuit, flavor, SRS (None: the example's default), inputs, set
        ("simple_mul", SimpleMulCircuit(), FLAVOR_HALO2, None, [42, 42, 42]),
        ("simple_mul_gwc19", SimpleMulCircuit(), FLAVOR_GWC, TrapdoorSRS.from_seed(b"test-srs"), [42, 42, 42]),
        ("lookup_table", LookupRangeCircuit(values=(3, 9, 14), bits=4), FLAVOR_HALO2, None, [7]),
        ("atms", AtmsCircuit(pks, sigs, MSG, 1), FLAVOR_HALO2, None, None),
        ("atms_with_lookups", AtmsLookupCircuit(pks, sigs, MSG, 1), FLAVOR_HALO2, None, None),
    )
    base = ("transcript", "pow_fr", "msm", "pairing", "decompress")
    for name, circuit, flavor, srs, inputs in cases:
        inputs = circuit.public_inputs() if inputs is None else inputs
        t0 = time.perf_counter()
        made, launches_k, keygen_s = counted(f"keygen {name}", lambda: keygen(circuit, flavor=flavor, srs=srs), ())
        pk, plan = made
        ext = max(2, 1 << (plan.degree - 1).bit_length())  # the prover's extension factor
        needs = POLY_KERNELS if plan.vk.n * ext >= 128 else ()  # simple_mul's arrays are all below 128
        proof, launches_p, prove_s = counted(f"prove {name}", lambda: prove(pk, plan, circuit, inputs), needs)
        files = artifacts.read_set(name)
        if proof.hex() != files["proof.hex"].strip():
            _fail(f"prove {name}: the card's proof differs from the committed {name}_proof.hex")
        if vk_to_json(plan.vk) != files["vk.json"]:
            _fail(f"keygen {name}: the card's VK text differs from the committed {name}_vk.json")
        print(f"[prove] {name} (k = {plan.vk.k}): keygen {keygen_s:.3f} s, prove {prove_s:.3f} s on the card, "
              f"{len(proof)} bytes equal to the committed proof, VK text equal; launches keygen {launches_k}, "
              f"prove {launches_p}")
        # (iii) the proof and its committed tampered twin through TorchVerifier
        invalid = bytes.fromhex(files["proof_invalid.hex"].strip())
        v = TorchVerifier(plan)
        batch = np.stack([np.frombuffer(proof, np.uint8), np.frombuffer(invalid, np.uint8)])
        pis = torch.from_numpy(v.encode_public_inputs([inputs] * 2)).to(dev)
        hints = torch.from_numpy(v.compute_y_hints(batch)).to(dev)
        out, launches_v, _s = counted(f"verify {name}", lambda: v.verify(torch.from_numpy(batch).to(dev), pis, hints,
                                                                          torch.Generator().manual_seed(0)), base)
        if out.cpu().tolist() != [True, False]:
            _fail(f"verify {name}: TorchVerifier gave {out.cpu().tolist()}, not [True, False]")
        print(f"[prove] {name}: TorchVerifier on the card [True, False], launches {launches_v} "
              f"({time.perf_counter() - t0:.1f} s with keygen and prove)")
    print(f"[prove] phase 10: {time.perf_counter() - t10:.1f} s")
    stamp("prove phase")


def _health() -> tuple[str, str]:
    """The card's ECC counters and the kernel log's Xid lines: a hardware
    witness beside the run's own checks."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=ecc.mode.current,ecc.errors.corrected.volatile.total,"
                        "ecc.errors.uncorrected.volatile.total,remapped_rows.pending,remapped_rows.failure",
                        "--format=csv,noheader"], capture_output=True, text=True)
    ecc = (q.stdout if q.returncode == 0 else f"not readable: {q.stdout}{q.stderr}").strip()
    dmesg = shutil.which("dmesg")
    d = subprocess.run([dmesg], capture_output=True, text=True) if dmesg else None
    if d is None or d.returncode:
        xid = "kernel log not readable" + (f": {d.stderr.strip()[:120]}" if d is not None else "")
    else:
        xid = " | ".join(line for line in d.stdout.splitlines() if "Xid" in line)[-600:] or "no Xid lines"
    return ecc, xid


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier
    from plutus_halo2_tpu_torch.ops import _build, cuda_blake, cuda_curve, cuda_field, cuda_fr, cuda_mma, cuda_pairing
    from plutus_halo2_tpu_torch.ops import limb
    from plutus_halo2_tpu_torch.ops import curve as tc
    from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC, limbs_to_int, window_digits
    from plutus_halo2_tpu_torch.refimpl import curve as rc
    from plutus_halo2_tpu_torch.refimpl.field import BLS_X, Q
    from plutus_halo2_tpu_torch.utils.profiling import WINDOW, device_busy_us, device_time_by_name, torch_trace
    from plutus_halo2_tpu_torch.utils import artifacts, serialization, tracing

    dev = torch.device("cuda")
    t_run = time.perf_counter()
    GLUE_OPS = (cuda_fr.mul, cuda_fr.add, cuda_fr.sub, cuda_fr.sum_lazy, cuda_fr.dot_lazy)

    def stamp(label):
        print(f"[time] {label}: {time.perf_counter() - t_run:.1f} s into the run")

    reported = [0]

    def report_refusals(label):
        """device_ms's windows refused since the last report."""
        new = WINDOW["refused"][reported[0]:]
        reported[0] = len(WINDOW["refused"])
        print(f"[timer] {label}: {len(new)} device_ms windows refused, fillers now {WINDOW['fillers']}")
        for r in new:
            print(f"[timer]   refused at {r['fillers']} fillers ({r['names']}): {r['reason']}")
    rng = np.random.default_rng(SEED)

    # ---- 1. environment -------------------------------------------------
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[env] nvcc {nvcc_ver.stdout.strip().splitlines()[-1]}")
    print(f"[env] device {kind} x{torch.cuda.device_count()} capability {torch.cuda.get_device_capability(0)}")
    print(f"[env] nvidia-smi: {card}")
    ecc_before, xid = _health()
    print(f"[env] ECC (mode, corrected, uncorrected volatile, remap pending, remap failed): {ecc_before}")
    print(f"[env] Xid: {xid}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(build {_build.build_seconds():.1f} s)")
    for line in _build.build_log().splitlines():
        if line.startswith("==") or any(k in line for k in ("entry function", "registers", "stack frame")):
            print(f"[build] {line.strip()}")
    lane_groups = {r["function"]: r for name in ("msm_kernel", "subgroup_kernel", "pow_kernel", "transcript_kernel",
                                                 "bf16_chain_kernel", "int8_chain_kernel", "mont_mul_kernel",
                                                 "fr_ntt_stage_kernel", "fr_mul_array_kernel", "fr_powers_",
                                                 "fr_glue_")
                   for r in _build.kernel_resources(name)}  # subgroup_kernel names the fused decompress too
    for r in lane_groups.values():
        print(f"[build] {r['function']}: {r['registers']} registers, {r['stack_bytes']} bytes stack frame, "
              f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")

    def rand_canon(spec, shape, gen=None):
        """Random canonical values < N as (shape..., L) limb tensors (from
        `gen`, the run's generator by default)."""
        n = int(np.prod(shape))
        raw = (gen or rng).integers(0, 256, size=(n, 2 * spec.L), dtype=np.uint8)
        vals = [int.from_bytes(r.tobytes(), "little") % spec.N for r in raw]
        limbs = np.frombuffer(b"".join(v.to_bytes(2 * spec.L, "little") for v in vals),
                              dtype=np.uint16).astype(np.int64)
        return torch.from_numpy(limbs.reshape(*shape, spec.L)).to(dev)

    results = {}

    def record(name, source, replaces, err, times, plain_ms, bound, library_ms=None):
        """times: (device ms, call ms) from _times; library_ms: device ms."""
        ms, call = times
        results[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "exact": err == 0, "max_abs_err": err, "ms": ms, "call_ms": call, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
        }
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms device"
        w = WINDOW["last"]  # the window of the kernel's device time (library_ms's, where there is one)
        print(f"[kernel] {name}: exact, {ms:.4f} ms device, {call:.4f} ms per call (plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.5f} ms by {bound[1]}{lib}; last window {w['busy_ms']:.4f} ms of kernels in "
              f"{w['event_ms']:.4f} ms of CUDA events, {w['host_ms']:.4f} ms enqueueing)")

    stamp("build")

    # ---- 3. field phase --------------------------------------------------
    for spec, kern in ((FP_SPEC, cuda_field.fp_mont_mul), (FR_SPEC, cuda_field.fr_mont_mul)):
        a, b = rand_canon(spec, (1 << 16,)), rand_canon(spec, (1 << 16,))
        got = kern(a, b)
        want = cuda_field.mont_mul_plain(a, b, spec)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).any(-1).sum())
            _fail(f"{spec.name} mont_mul kernel differs from the plain product on {bad} of 65536")
        print(f"[field] {spec.name} mont_mul kernel == plain on 65536 pairs")
        if spec is FP_SPEC:  # one CIOS product per pair; each pair read, its product written
            record("mont_mul", "plutus_halo2_tpu_torch/csrc/field_test.cu", "tests/test_pallas_core.py:139", 0,
                   _times(lambda: kern(a, b), "mont_mul_kernel", 20),
                   _call_ms(lambda: cuda_field.mont_mul_plain(a, b, spec), 5),
                   _bound_ms(2 * a.shape[0] * _cios_products(12), 8 * 3 * a.numel()))

    # the Fr glue's kernels against the plain Field, at the verifier's shapes
    # (their own generator: the later phases draw what they drew before)
    g_rng = np.random.default_rng(SEED + 1)
    x, consts, pooled = (rand_canon(FR_SPEC, s, g_rng) for s in ((B,), (1, 36), (B, 40)))
    below_2_256 = torch.from_numpy(g_rng.integers(0, 1 << 16, size=(B, 41, FR_SPEC.L))).to(dev)
    below_2_256[..., -1] = 0
    fr_plain = limb.Field(FR_SPEC)
    glue_checks = {
        "mul (B, 1) x (1, 36)": lambda f: f.mul(x[:, None, :], consts),
        "sub (B, 1) - (1, 36)": lambda f: f.sub(x[:, None, :], consts),
        "to_mont (B, 41) below 2^256": lambda f: f.to_mont(below_2_256),
        "from_mont (B, 40)": lambda f: f.from_mont(pooled),
        "add (B,) + (1,)": lambda f: f.add(x, consts[0, 0]),
        "neg (B,)": lambda f: f.neg(x),
        "sum_lazy pooled[:, 1:6]": lambda f: f.sum_lazy(pooled[:, 1:6, :], dim=-2),
        "dot_lazy (B, 3)": lambda f: f.dot_lazy(pooled[:, 3:6, :], pooled[:, 30:33, :], dim=-2),
        "batch_inv (B, 40)": lambda f: f.batch_inv(pooled, dim=-2),
        "pow x^(2^20)": lambda f: f.pow(x, 1 << 20),
    }
    copies = cuda_fr.layout_copies
    for label, fn in glue_checks.items():
        got, want = fn(limb.fr), fn(fr_plain)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"fr glue {label}: the kernels differ from the plain version on "
                  f"{int((got != want).any(-1).sum())} elements")
    if cuda_fr.layout_copies != copies:
        _fail(f"fr glue: {cuda_fr.layout_copies - copies} layout copies at the verifier's shapes")
    print(f"[field] fr glue kernels == plain at B = {B}: {', '.join(glue_checks)} ("
          f"launches {({f.__name__: f.launches for f in GLUE_OPS})}, 0 layout copies)")
    record("fr_glue", "plutus_halo2_tpu_torch/csrc/fr_glue.cu", "none (the plain-torch Fr glue, ops/limb.py)", 0,
           _times(lambda: cuda_fr.mul(x[:, None, :], consts), "fr_glue_mul", 20),
           _call_ms(lambda: fr_plain.mul(x[:, None, :], consts), 5),
           _bound_ms(2 * B * 36 * _cios_products(8), 8 * FR_SPEC.L * (B + 36 + B * 36)))

    stamp("field phase")

    # ---- the slice's inputs --------------------------------------------
    def load_set(name):
        """(plan, honest proof, invalid twin, public inputs) of a committed
        set (utils/artifacts.py), the proofs as uint8 arrays."""
        plan_s, good, bad_s, pis_s = artifacts.load_set(name)
        return plan_s, np.frombuffer(good, np.uint8), np.frombuffer(bad_s, np.uint8), pis_s

    plan, proof_h, proof_bad, pis = load_set("simple_mul")
    verifier = TorchVerifier(plan, subgroup_check="off")  # device defaults to cuda

    # the circuits phase's sets: the GWC19 flavor of simple_mul (the port's
    # own committed set), the lookup and ATMS circuits (the JAX package's)
    sets = {n: load_set(n) for n in ("simple_mul_gwc19", "lookup_table", "atms", "atms_with_lookups",
                                     "atms_228_408", "atms_with_lookups_50_90_gwc19")}
    set_verifiers = {}

    def set_verifier(name):
        """The default-mode verifier (aggregate subgroup test, device cuda) of a set."""
        if name not in set_verifiers:
            set_verifiers[name] = TorchVerifier(sets[name][0])
        return set_verifiers[name]

    batch = np.stack([proof_h] * B).copy()
    expected = np.ones(B, bool)
    invalid_rows = np.arange(3, B, 8)
    batch[invalid_rows] = proof_bad
    expected[invalid_rows] = False
    flip_row = 5
    batch[flip_row, 100] ^= 0x40
    expected[flip_row] = False
    proof_t = torch.from_numpy(batch).to(dev)
    pis_t = torch.from_numpy(verifier.encode_public_inputs([pis] * B)).to(dev)

    # ---- 4. kernel phases ------------------------------------------------
    def limb_err(x, y):
        return int((x - y).abs().max()) if x.numel() else 0

    # transcript, on the batch's real transcript buffers
    lengths = [l for _n, l in verifier.layout.squeezes]
    buf = verifier.transcript_buffer(proof_t, pis_t)
    h1, h2 = cuda_blake.transcript_hashes(buf, lengths)
    (p1, p2), plain_ms = _plain(lambda: cuda_blake.transcript_hashes_plain(buf, lengths))
    torch.cuda.synchronize()
    if not (torch.equal(h1, p1) and torch.equal(h2, p2)):
        _fail("transcript kernel differs from the plain Blake2b")
    record("transcript", "plutus_halo2_tpu_torch/csrc/blake2b.cu",
           "plutus_halo2_tpu/ops/pallas_blake.py:82",
           max(limb_err(h1, p1), limb_err(h2, p2)),
           _times(lambda: cuda_blake.transcript_hashes(buf, lengths), "transcript_kernel", 20), plain_ms,
           _bound_ms(B * _blake_ops(lengths), buf.numel() + 8 * (h1.numel() + h2.numel())))
    transcript_checks(buf, lengths, rng)

    # pow: the Fr inversion root (B, 1) and the Fp sqrt ladder (B, 10)
    n_pts = len(verifier.layout.point_offsets)
    for name, spec, shape, e, kern in (
        ("pow_fr", FR_SPEC, (B, 1), Q - 2, cuda_field.fr_pow),
        ("pow_fp", FP_SPEC, (B, n_pts), (FP_SPEC.N + 1) >> 2, cuda_field.fp_pow),
    ):
        x = rand_canon(spec, shape)
        special = [spec.to_mont(0), spec.to_mont(1), spec.to_mont(spec.N - 1), spec.encode(1), spec.encode(spec.N - 1)]
        x.view(-1, spec.L)[: len(special)] = torch.from_numpy(np.stack(special)).to(dev)
        got = kern(x, e)
        want, plain_ms = _plain(lambda: cuda_field.pow_plain(x, spec, e))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"{name} kernel differs from the plain pow")
        nw = 12 if spec is FP_SPEC else 8
        n = int(np.prod(shape))
        ops = 2 * n * _pow_products(window_digits(e)) * _cios_products(nw)
        record(name, "plutus_halo2_tpu_torch/csrc/pow.cu", "plutus_halo2_tpu/ops/pallas_field.py:32",
               limb_err(got, want), _times(lambda: kern(x, e), "pow_kernel", 10), plain_ms,
               _bound_ms(ops, 2 * 8 * x.numel()))

    # MSM at the multi-open shape (K = 16 after dedup): random G1 points
    # (one identity among them), random scalars (some zero, one q - 1)
    K = 16
    host_pts = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=47)] + [None]
    pt_tab = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in host_pts])).to(dev)
    pts = pt_tab[torch.from_numpy(rng.integers(0, len(host_pts), size=(B, K))).to(dev)].contiguous()
    sc = rand_canon(FR_SPEC, (B, K))
    sc[0, 1] = 0
    sc[1, 2] = torch.from_numpy(FR_SPEC.encode(Q - 1)).to(dev)

    def msm_check(pts, sc, wbits=5, ref=None):
        """The kernel against the plain version of its decomposition (limb for
        limb) and the per-point MSM (affine; `ref`, when given, is that
        already); the kernel's output, the plain one, its call ms and ref."""
        got = cuda_curve.msm(pts, sc, wbits=wbits)
        want, plain_ms = _plain(lambda: tc.msm_windowed(pts, sc, wbits))
        ref = ref if ref is not None else tc.to_affine(cuda_curve.msm_plain(pts, sc))
        ga = tc.to_affine(got)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"MSM kernel at {tuple(pts.shape[:2])}, wbits {wbits} differs from the plain windowed MSM on "
                  f"{int((got != want).any(-1).any(-1).sum())} rows")
        if not all(torch.equal(x, y) for x, y in zip(ga, ref)):
            _fail(f"MSM kernel at {tuple(pts.shape[:2])}, wbits {wbits} differs from the per-point MSM (affine)")
        return got, want, plain_ms, ref

    def msm_bound(pts, sc):
        live = (pts[:, :, 2].abs().sum(-1) != 0).cpu().tolist()
        ints = [[limbs_to_int(v) for v in row] for row in sc.cpu().numpy()]
        products = sum(_msm_fp_products(s, l) for s, l in zip(ints, live))
        return _bound_ms(2 * products * _cios_products(12),
                         8 * (pts.numel() + sc.numel() + pts.shape[0] * 3 * FP_SPEC.L))

    got, want, plain_ms, ref = msm_check(pts, sc)
    bound = msm_bound(pts, sc)
    record("msm", "plutus_halo2_tpu_torch/csrc/msm.cu", "plutus_halo2_tpu/ops/pallas_curve.py:233",
           limb_err(got, want), _times(lambda: cuda_curve.msm(pts, sc), "msm_kernel", 10), plain_ms, bound)
    # the stage probe's width (msmp): 64 signed 4-bit windows, 9 table entries
    msm_check(pts, sc, wbits=4, ref=ref)
    print(f"[kernel] msm at wbits 4: exact, "
          f"{_times(lambda: cuda_curve.msm(pts, sc, wbits=4), 'msm_kernel', 10)[0]:.4f} ms device "
          f"(the same function: bound {bound[0]:.4f} ms by {bound[1]})")
    # the RLC aggregation's shape in verify_rlc(group=8): K = 8 at B / 4 rows
    pts8, sc8 = pts[: B // 4, :8].contiguous(), sc[: B // 4, :8].contiguous()
    plain_ms = msm_check(pts8, sc8)[2]
    times = _times(lambda: cuda_curve.msm(pts8, sc8), "msm_kernel", 10)
    bound = msm_bound(pts8, sc8)
    print(f"[kernel] msm at ({B // 4}, 8): exact, {times[0]:.4f} ms device, {times[1]:.4f} ms per call "
          f"(plain {plain_ms:.3f} ms, bound {bound[0]:.5f} ms by {bound[1]})")

    # pairing: a row of its own per check, built from the slice's honest
    # pairing sides (el, er): rows 0, 2 mod 4 are true pairs ([r]el, [r]er),
    # rows 1 mod 4 mismatched ([r]el, [s]er), rows 3 mod 4 random G1 points
    # ([r]G, [s]G); row 0 is (O, O) (true), row 1 (O, [s]er) (false)
    el_h, er_h, _valid = verifier.core(proof_t, pis_t)
    h = int(np.nonzero(expected)[0][0])
    row_kind = torch.arange(B, device=dev) % 4
    gen = torch.from_numpy(tc.host_point_to_mont(rc.G1_GEN)).to(dev)
    rnd = row_kind[:, None, None] == 3
    r_sc, s_sc = rand_canon(FR_SPEC, (B,)), rand_canon(FR_SPEC, (B,))
    r_sc[:2] = 0
    true_row = (row_kind == 0) | (row_kind == 2)
    base = torch.cat([torch.where(rnd, gen, el_h[h]), torch.where(rnd, gen, er_h[h])])
    scal = torch.cat([r_sc, torch.where(true_row[:, None], r_sc, s_sc)])
    sides = cuda_curve.msm_plain(base[:, None].contiguous(), scal[:, None].contiguous())
    el, er = sides[:B].contiguous(), sides[B:].contiguous()
    def pairing_bound(el, er):
        live = (~tc.is_identity(el)).to(torch.int64) + (~tc.is_identity(er)).to(torch.int64)
        ops = sum(_pairing_ops(int(n), BLS_X) for n in live.tolist())
        return _bound_ms(ops, 8 * (el.numel() + er.numel()) + el.shape[0])

    # at B, then at the RLC group check's 128 rows and at 64 rows (the first
    # checks)
    for n in (B, RLC_ROWS, 64):
        el_n, er_n = el[:n].contiguous(), er[:n].contiguous()
        got = cuda_pairing.pairing_check(el_n, er_n, verifier.pair)
        want, plain_ms = _plain(lambda: cuda_pairing.pairing_check_plain(el_n, er_n, verifier.pair))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"pairing kernel differs from the plain pairing check on {int((got != want).sum())} "
                  f"of {n} rows")
        if not torch.equal(got, true_row[:n]):
            _fail(f"pairing verdicts differ from the rows' construction at {n} rows")
        times = _times(lambda: cuda_pairing.pairing_check(el_n, er_n, verifier.pair), "pairing_kernel", 5)
        if n == B:
            record("pairing", "plutus_halo2_tpu_torch/csrc/pairing.cu",
                   "plutus_halo2_tpu/ops/pallas_pairing.py:419", int((got != want).sum()), times, plain_ms,
                   pairing_bound(el_n, er_n))
        else:
            bound = pairing_bound(el_n, er_n)
            print(f"[kernel] pairing at {n} rows: exact, {times[0]:.4f} ms device, {times[1]:.4f} ms per call "
                  f"(plain {plain_ms:.3f} ms, bound {bound[0]:.5f} ms by {bound[1]})")
    print(f"[kernel] pairing rows: {B} distinct checks, {int(true_row.sum())} true, "
          f"{int((~true_row).sum())} false")

    # hinted decompression at (B, 10): the proof's points with their hints;
    # in three of every four rows one point replaced by a crafted encoding
    # (encoding, hint, decodes, lies in G1)
    P = FP_SPEC.N
    evil = _nonsubgroup_point(P, rc.g1_in_subgroup)
    lay = verifier.layout
    x_nr = next(x for x in range(1, 1000) if pow((x**3 + 4) % P, (P - 1) // 2, P) == P - 1)
    flagged = lambda v: bytes([v.to_bytes(48, "big")[0] | 0x80]) + v.to_bytes(48, "big")[1:]  # noqa: E731

    def crafted_rows(v, proof, n):
        """(raw, hints, decodes, member) at n rows of proof's points under
        verifier v's layout, with their hints, three of every four rows with
        one point crafted from the proof's first point."""
        honest_raw = np.stack([proof[o : o + 48] for o in v.layout.point_offsets.values()])
        honest_hints = v.compute_y_hints(proof[None])[0]
        y0 = limbs_to_int(honest_hints[0])
        crafted = [
            (rc.g1_compress(evil), evil[1], True, False),                # outside G1
            (bytes([0xC0] + [0] * 47), 0, True, True),                   # infinity
            (bytes([0xC0, 1] + [0] * 46), 0, False, True),               # bad infinity
            (flagged(P + 2), 3, False, True),                            # x >= p
            (flagged(x_nr), 12345, False, True),                         # x^3 + 4 not a square
            (bytes([honest_raw[0, 0] & 0x7F]) + honest_raw[0, 1:].tobytes(), y0, False, True),  # no flag
            (honest_raw[0].tobytes(), y0 + 1, False, True),              # wrong hint
            (honest_raw[0].tobytes(), y0 + (7 << 384), True, True),      # oversized hint: mod 2^384
        ]
        k = honest_raw.shape[0]
        raw = np.broadcast_to(honest_raw, (n, k, 48)).copy()
        hints = np.broadcast_to(honest_hints, (n, k, FP_SPEC.L)).copy()
        decodes = np.ones((n, k), bool)
        member = np.ones(n, bool)
        for r in range(n):
            if r % 4:
                enc, hint, ok, in_g1 = crafted[(r // 4) % len(crafted)]
                raw[r, r % k] = np.frombuffer(enc, np.uint8)
                hints[r, r % k] = [(hint >> (16 * j)) & 0xFFFF for j in range(FP_SPEC.L)]
                decodes[r, r % k], member[r] = ok, in_g1
        return raw, hints, decodes, member

    def decompress_check(raw, hints, decodes, member, sub_w):
        """The fused and the unfused kernel against the plain version and
        the rows' construction: (fused output, plain output, plain ms)."""
        raw_t, hints_t = torch.from_numpy(raw).to(dev), torch.from_numpy(hints).to(dev)
        shape = tuple(raw.shape[:2])
        got = cuda_curve.decompress_hinted(raw_t, hints_t, sub_w)
        want, plain_ms = _plain(lambda: cuda_curve.decompress_hinted_plain(raw_t, hints_t, sub_w))
        unfused = cuda_curve.decompress_hinted(raw_t, hints_t)
        torch.cuda.synchronize()
        rows_ok = got[1].all(-1)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            _fail(f"decompress kernel's points or valid flags differ from the plain version at {shape}")
        if not (torch.equal(unfused[0], got[0]) and torch.equal(unfused[1], got[1])):
            _fail(f"unfused decompress kernel differs from the fused one at {shape}")
        if not torch.equal(got[1].cpu(), torch.from_numpy(decodes)):
            _fail(f"decompress valid flags differ from the encodings' construction at {shape}")
        if not (torch.equal(got[2][rows_ok], want[2][rows_ok])
                and torch.equal(got[2] & rows_ok, want[2] & rows_ok)):
            _fail(f"fused subgroup verdicts differ from the plain version on rows that decode at {shape}")
        if not torch.equal(got[2][rows_ok].cpu(), torch.from_numpy(member)[rows_ok.cpu()]):
            _fail(f"fused subgroup verdicts differ from the rows' construction at {shape}")
        if not torch.equal(got[2][rows_ok], tc.aggregate_subgroup_check(want[0], sub_w)[rows_ok]):
            _fail(f"fused subgroup verdicts differ from the per-point aggregate test on rows that decode "
                  f"at {shape}")
        return got, want, plain_ms

    def decompress_bound(raw, hints, got, sub_w):
        live_pts = (~tc.is_identity(got[0])).cpu().numpy()
        dec_products = DECODE_FP_PRODUCTS * int((raw[..., 0] & 0x40 == 0).sum())
        agg_products = sum(_aggregate_fp_products(sub_w.tolist(), list(lv)) for lv in live_pts)
        return _bound_ms(2 * (dec_products + agg_products) * _cios_products(12),
                         raw.size + 8 * hints.size + 8 * got[0].numel() + got[1].numel() + raw.shape[0])

    raw, hints, decodes, member = crafted_rows(verifier, proof_h, B)
    raw_t, hints_t = torch.from_numpy(raw).to(dev), torch.from_numpy(hints).to(dev)
    sub_w = tc.subgroup_weights(n_pts, 1, torch.Generator().manual_seed(SEED))
    got, want, plain_ms = decompress_check(raw, hints, decodes, member, sub_w)
    rows_ok = got[1].all(-1)
    record("decompress", "plutus_halo2_tpu_torch/csrc/decompress.cu",
           "plutus_halo2_tpu/ops/pallas_curve.py:367",
           limb_err(got[0], want[0]),
           _times(lambda: cuda_curve.decompress_hinted(raw_t, hints_t, sub_w), "decompress_subgroup_kernel", 20),
           plain_ms, decompress_bound(raw, hints, got, sub_w))
    unfused_ms = _times(lambda: cuda_curve.decompress_hinted(raw_t, hints_t), "decompress_kernel", 20)[0]
    print(f"[kernel] decompress rows: {int(rows_ok.sum())} of {B} decode, "
          f"{int((rows_ok & got[2]).sum())} of them in G1; unfused variant {unfused_ms:.4f} ms device "
          f"(plain {_call_ms(lambda: cuda_curve.decompress_hinted_plain(raw_t, hints_t), 2):.3f} ms)")

    # hintless decompression at (B, 10) on the same encodings (a wrong or
    # oversized hint's row decodes here): points and flags against the plain
    # version (curve.decompress without a hint) and the spec's decoder
    spec_decodes = {}
    for enc in {r.tobytes() for r in raw.reshape(-1, 48)}:
        try:
            rc.g1_decompress(enc)
            spec_decodes[enc] = True
        except ValueError:
            spec_decodes[enc] = False
    got_h = cuda_curve.decompress_hintless(raw_t)
    want_h, plain_ms = _plain(lambda: tc.decompress(raw_t))
    torch.cuda.synchronize()
    if not (torch.equal(got_h[0], want_h[0]) and torch.equal(got_h[1], want_h[1])):
        _fail(f"sqrt_decode kernel's points or valid flags differ from the plain version at {tuple(raw.shape[:2])}")
    if got_h[1].cpu().numpy().ravel().tolist() != [spec_decodes[r.tobytes()] for r in raw.reshape(-1, 48)]:
        _fail("sqrt_decode valid flags differ from the spec's decoder")
    # per point that is not an infinity encoding: the ladder, and x into the
    # domain, x^2, x^3, y^2, canonical y, x and y out
    sqrt_products = (_pow_products(window_digits((P + 1) >> 2)) + 7) * int((raw[..., 0] & 0x40 == 0).sum())
    record("sqrt_decode", "plutus_halo2_tpu_torch/csrc/sqrt_decode.cu",
           "plutus_halo2_tpu/ops/pallas_field.py:32 (make_pow_kernel's Fp (p+1)/4 ladder) and the decoding "
           "the JAX package runs around it under XLA",
           limb_err(got_h[0], want_h[0]),
           _times(lambda: cuda_curve.decompress_hintless(raw_t), "sqrt_decode_kernel", 10), plain_ms,
           _bound_ms(2 * sqrt_products * _cios_products(12), raw.size + 8 * got_h[0].numel() + got_h[1].numel()))
    print(f"[kernel] sqrt_decode rows: {int(got_h[1].all(-1).sum())} of {B} decode without hints; the pow kernel "
          f"alone on (B, {n_pts}) above")

    # aggregate subgroup test at (B, 10) on decoded points: honest rows, rows
    # with identities, rows with a point outside G1; rounds 1 and 2
    pts_ok = got[0][rows_ok][:1].expand(B, -1, -1, -1).clone()
    ident = torch.from_numpy(tc.host_point_to_mont(None)).to(dev)
    evil_pt = torch.from_numpy(tc.host_point_to_mont(evil)).to(dev)
    sub_kind = torch.arange(B, device=dev) % 3  # 0 honest, 1 identities, 2 outside G1
    pts_ok[sub_kind == 1, 1::3] = ident
    pts_ok[sub_kind == 2, 4] = evil_pt
    pts_ok = pts_ok.contiguous()
    sub_member = sub_kind != 2
    live_sub = (~tc.is_identity(pts_ok)).cpu().numpy()
    for rounds in (1, 2):
        w_r = tc.subgroup_weights(n_pts, rounds, torch.Generator().manual_seed(SEED + rounds))
        ok_k = cuda_curve.aggregate_subgroup_check(pts_ok, w_r)
        ok_p, plain_ms = _plain(lambda: cuda_curve.aggregate_subgroup_check_plain(pts_ok, w_r))
        ok_w = tc.aggregate_subgroup_check_windowed(pts_ok, w_r)
        torch.cuda.synchronize()
        if not torch.equal(ok_k, ok_p):
            _fail(f"subgroup kernel differs from the plain version at {rounds} rounds")
        if not torch.equal(ok_k, ok_w):
            _fail(f"subgroup kernel differs from the plain version of its decomposition at {rounds} rounds")
        if not torch.equal(ok_k, sub_member):
            _fail(f"subgroup verdicts differ from the rows' construction at {rounds} rounds")
        times = _times(lambda: cuda_curve.aggregate_subgroup_check(pts_ok, w_r), "subgroup_kernel", 20)
        bound = _bound_ms(2 * sum(_aggregate_fp_products(w_r.tolist(), list(lv)) for lv in live_sub)
                          * _cios_products(12), 8 * pts_ok.numel() + B)
        if rounds == 1:
            record("subgroup", "plutus_halo2_tpu_torch/csrc/subgroup.cu",
                   "plutus_halo2_tpu/ops/pallas_curve.py:642", int((ok_k != ok_p).sum()), times, plain_ms,
                   bound)
        else:
            print(f"[kernel] subgroup at 2 rounds: exact, {times[0]:.3f} ms device (plain {plain_ms:.3f} ms, "
                  f"bound {bound[0]:.4f} ms by {bound[1]})")
    print(f"[kernel] subgroup rows: {int(sub_member.sum())} in G1, {int((~sub_member).sum())} not")

    # tensor-core probe kernels on tools/mxu_probe.py's inputs (default_rng(0),
    # integers in [0, 127)): bit for bit at the probe's width B and at ragged
    # widths, the bf16 chain equal to the int8 chain
    def probe_inputs(n):
        r = np.random.default_rng(0)
        mat = r.integers(0, 127, (cuda_mma.M, cuda_mma.K)).astype(np.int8)
        vec = r.integers(0, 127, (cuda_mma.K, n)).astype(np.int8)
        return torch.from_numpy(mat).to(dev), torch.from_numpy(vec).to(dev)

    for n in (1, 17, 128, B):
        mat, vec = probe_inputs(n)
        dot, c8, c16 = cuda_mma.int8_dot(mat, vec), cuda_mma.int8_chain(mat, vec), cuda_mma.bf16_chain(mat, vec)
        want_dot, want_chain = cuda_mma.int8_dot_plain(mat, vec), cuda_mma.chain_plain(mat, vec)
        torch.cuda.synchronize()
        for name, got, want in (("int8_dot", dot, want_dot), ("int8_chain", c8, want_chain),
                                ("bf16_chain", c16, want_chain)):
            if not torch.equal(got, want):
                _fail(f"{name} kernel differs from its plain version at B = {n} on "
                      f"{int((got != want).sum())} of {want.numel()} values")
    print("[kernel] probe kernels exact at B = 1, 17, 128, 1024; the bf16 chain equals the int8 chain")
    steps = cuda_mma.STEPS
    product_ops = 2 * cuda_mma.M * cuda_mma.K * B
    # a chain step's output is only the K rows the next step reads; the
    # kernel computes all M, as the Pallas kernel does, but the bound counts
    # what the function needs
    step_ops = 2 * cuda_mma.K * cuda_mma.K * B
    in_bytes = mat.numel() + vec.numel()
    if not torch.equal(torch._int_mm(mat, vec), want_dot):  # the yardstick (cuBLASLt), never used by the port
        _fail("torch._int_mm differs from the exact product")
    record("int8_dot", "plutus_halo2_tpu_torch/csrc/mma_probe.cu", "tools/mxu_probe.py:46", 0,
           _times(lambda: cuda_mma.int8_dot(mat, vec), "int8_dot_kernel", 50),
           _call_ms(lambda: cuda_mma.int8_dot_plain(mat, vec), 5),
           _bound_ms(product_ops, in_bytes + 4 * dot.numel(), TC_INT8_OPS_PER_S),
           # every device kernel the library call launches
           _times(lambda: torch._int_mm(mat, vec), None, 50)[0])
    for name, kern, kernel, source, line, peak in (
        ("int8_chain", cuda_mma.int8_chain, "int8_chain_kernel", "mma_chain.cu", 101, TC_INT8_OPS_PER_S),
        ("bf16_chain", cuda_mma.bf16_chain, "bf16_chain_kernel", "mma_chain.cu", 122, TC_BF16_FLOPS),
    ):
        times = _times(lambda: kern(mat, vec), kernel, 20)
        record(name, f"plutus_halo2_tpu_torch/csrc/{source}", f"tools/mxu_probe.py:{line}", 0, times,
               _call_ms(lambda: cuda_mma.chain_plain(mat, vec), 3),
               _bound_ms(steps * step_ops, in_bytes + 4 * c8.numel(), peak))
        print(f"[kernel] {name}: {times[0] * 1e3 / steps:.4f} us per product ({steps} dependent products)")
    # one warp alone (16 columns): a step's latency, without the card's
    # other warps; the 200 dependent steps can take no less than 200 of them
    mat16, vec16 = probe_inputs(16)
    for name, kern, kernel in (("int8_chain", cuda_mma.int8_chain, "int8_chain_kernel"),
                               ("bf16_chain", cuda_mma.bf16_chain, "bf16_chain_kernel")):
        one = [_times(lambda: kern(mat16, vec16, n), kernel, 20)[0] for n in (0, steps)]
        step_us = (one[1] - one[0]) * 1e3 / steps
        print(f"[kernel] {name} step latency on one warp: {step_us:.4f} us ({one[1]:.4f} ms at {steps} steps, "
              f"{one[0]:.4f} at 0); dependent-step floor {steps * step_us / 1e3:.4f} ms at B = {B} "
              f"(device {results[name]['ms']:.4f})")

    stamp("kernel phase")
    report_refusals("field and kernel phases")

    # the MSM and the fused decompress kernel at the circuits phase's shapes,
    # each held against its plain versions on the full (B, K) tensors that
    # are then timed and bounded. The MSM at the multi-open K of the GWC19
    # flavor (simple_mul's 3 and 17, ATMS 50/90 with lookups' 4 and 38) and
    # of the halo2-book lookup and ATMS circuits (19, 32, 36), on random
    # points (identities among them) and scalars (a zero, a q - 1); the
    # per-point references are the prefix sums of one pass of products,
    # kept also at the mp-2 slices' K (9, 16, 18) that phase 6e times
    pts_c = pt_tab[torch.from_numpy(rng.integers(0, len(host_pts), size=(B, 38))).to(dev)].contiguous()
    sc_c = rand_canon(FR_SPEC, (B, 38))
    sc_c[0, 1] = 0
    sc_c[1, 2] = torch.from_numpy(FR_SPEC.encode(Q - 1)).to(dev)
    products = tc.mul(pts_c, sc_c)
    acc, refs = products[:, 0], {}
    for j in range(1, 38):
        acc = tc.add(acc, products[:, j])
        if j + 1 in (3, 4, 9, 16, 17, 18, 19, 32, 36, 38):
            refs[j + 1] = tc.to_affine(acc)
    for k in (3, 4, 17, 19, 32, 36, 38):
        pts_k, sc_k = pts_c[:, :k].contiguous(), sc_c[:, :k].contiguous()
        plain_ms = msm_check(pts_k, sc_k, ref=refs[k])[2]
        times = _times(lambda: cuda_curve.msm(pts_k, sc_k), "msm_kernel", 10)
        bound = msm_bound(pts_k, sc_k)
        print(f"[kernel] msm at ({B}, {k}): exact (plain {plain_ms:.3f} ms), {times[0]:.4f} ms device, "
              f"{times[1]:.4f} ms per call, bound {bound[0]:.5f} ms by {bound[1]} (ratio {times[0] / bound[0]:.1f})")
    # the fused decompress kernel at the proof points of simple_mul GWC19
    # (11), lookup_table (15), atms_with_lookups (18) and
    # atms_with_lookups_50_90_gwc19 (20), crafted as above
    for name in ("simple_mul_gwc19", "lookup_table", "atms_with_lookups", "atms_with_lookups_50_90_gwc19"):
        raw_c, hints_c, dec_c, mem_c = crafted_rows(set_verifier(name), sets[name][1], B)
        k = raw_c.shape[1]
        w_c = tc.subgroup_weights(k, 1, torch.Generator().manual_seed(SEED + k))
        got_c, _want_c, plain_ms = decompress_check(raw_c, hints_c, dec_c, mem_c, w_c)
        raw_ct, hints_ct = torch.from_numpy(raw_c).to(dev), torch.from_numpy(hints_c).to(dev)
        times = _times(lambda: cuda_curve.decompress_hinted(raw_ct, hints_ct, w_c),
                       "decompress_subgroup_kernel", 20)
        bound = decompress_bound(raw_c, hints_c, got_c, w_c)
        print(f"[kernel] decompress (fused, 1 round) at ({B}, {k}) ({name}): exact (plain {plain_ms:.3f} ms), "
              f"{times[0]:.4f} ms device, {times[1]:.4f} ms per call, bound {bound[0]:.5f} ms by {bound[1]} "
              f"(ratio {times[0] / bound[0]:.1f})")

    stamp("the circuits' kernel shapes")
    report_refusals("the circuits' kernel shapes")

    # ---- 5. the paths ------------------------------------------------------
    counters = {
        "transcript": cuda_blake.transcript_hashes, "pow_fr": cuda_field.fr_pow,
        "pow_fp": cuda_field.fp_pow, "sqrt_decode": cuda_curve.decompress_hintless, "msm": cuda_curve.msm,
        "pairing": cuda_pairing.pairing_check, "decompress": cuda_curve.decompress_hinted,
        "subgroup": cuda_curve.aggregate_subgroup_check,
        "mont_mul": cuda_field.fp_mont_mul, "int8_dot": cuda_mma.int8_dot,
        "int8_chain": cuda_mma.int8_chain, "bf16_chain": cuda_mma.bf16_chain,
    }
    for r in results.values():
        r["launches"] = 0

    def counted(name, fn, needs):
        """One run of fn with the launch counts set to 0 before it and read
        after it (the Fr glue's five ops as one, "fr_glue"; its layout
        copies and Fr ops on the plain path too); every kernel in `needs`
        must have launched."""
        for f in (*counters.values(), *GLUE_OPS):
            f.launches = 0
        cuda_fr.layout_copies = cuda_fr.plain_on_cuda = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        launches["fr_glue"] = sum(f.launches for f in GLUE_OPS)
        for k in needs:
            if launches[k] <= 0:
                _fail(f"path {name}: kernel {k} was not launched")
        for k, n in launches.items():
            results[k]["launches"] += n
        return out, {k: n for k, n in launches.items() if n}, first_s

    def run_path(name, fn, want, needs):
        """One path's first call, counted; its verdicts against the expected
        vector."""
        out, launches, first_s = counted(name, fn, needs)
        glue = {f.__name__: f.launches for f in GLUE_OPS}
        print(f"[path] {name}: fr glue launches {glue}, layout copies {cuda_fr.layout_copies}, "
              f"Fr ops on the plain path with a CUDA tensor {cuda_fr.plain_on_cuda}")
        if not launches["fr_glue"] or cuda_fr.layout_copies or cuda_fr.plain_on_cuda:
            _fail(f"path {name}: the Fr glue launched {launches['fr_glue']} kernels, copied "
                  f"{cuda_fr.layout_copies} operands, sent {cuda_fr.plain_on_cuda} ops to the plain path")
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        if not np.array_equal(out, want):
            _fail(f"path {name}: verdicts differ from the expected vector at rows "
                  f"{np.nonzero(out != want)[0][:10].tolist()}")
        print(f"[path] {name}: verdicts exact ({int(want.sum())} accept, {int((~want).sum())} reject), "
              f"launches {launches}, first call {first_s:.3f} s")
        return launches

    def stage_table(label, calls, wall):
        """Median device ms per stage of the traced calls (a child stage
        indented under its parent, whose self time follows), the graph's
        span, and "other": the wall time the graph leaves (host checks,
        staging, clones, the sync)."""
        names = list(dict.fromkeys((s.name, s.parent is not None) for s in calls[0].stages))
        for name, child in names:
            ms = statistics.median(c.stage_ms(name) for c in calls)
            own = "" if child else f" (self {statistics.median(c.self_ms(name) for c in calls):.3f} ms)"
            print(f"[path] {label} stage {'  ' * child + name:<12} {ms:9.3f} ms{own}")
        graph = statistics.median(c.graph_ms for c in calls)
        print(f"[path] {label} stage {'graph':<12} {graph:9.3f} ms (the stages tile it: "
              f"{statistics.median(c.top_ms() for c in calls):.3f} ms)")
        print(f"[path] {label} stage {'other':<12} {wall * 1e3 - graph:9.3f} ms (host checks, staging, clones, sync)")

    def traced_timed(label, fn):
        """timed(fn) in the graph form, traced: a first call captures the
        key's traced program, the three timed calls replay it; then their
        stage table. Returns the median wall."""
        tracing.enable()
        try:
            fn()
            tracing.RECORDER.clear()
            wall = timed(fn)
            calls = [c for c in tracing.calls() if c.device is not None]
        finally:
            tracing.disable()
        print(f"[path] {label}: {B / wall:.1f} proofs/s (median of 3 calls in the graph form, traced: "
              f"{wall * 1e3:.1f} ms per batch)")
        stage_table(label, calls, wall)

    def timed(fn, calls=3):
        walls = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    # one row that only the pairing rejects (a corrupted proof scalar: every
    # point still decodes and lies in G1), so that RLC re-checks its group
    EVIL_ROW, HINT_ROW, SCALAR_ROW = 6, 7, 1
    batch[SCALAR_ROW, list(lay.scalar_offsets.values())[0] + 3] ^= 0x40
    expected[SCALAR_ROW] = False
    batch[EVIL_ROW, 0:48] = np.frombuffer(rc.g1_compress(evil), np.uint8)  # first advice commitment
    expected[EVIL_ROW] = False
    proof_t = torch.from_numpy(batch).to(dev)
    t0 = time.perf_counter()
    hints = verifier.compute_y_hints(batch)
    print(f"[path] compute_y_hints host time at B={B}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"({len(np.unique(batch, axis=0))} distinct proofs)")
    hints[HINT_ROW, 2, 0] ^= 1
    hints_t = torch.from_numpy(hints).to(dev)
    hinted = expected.copy()
    hinted[HINT_ROW] = False
    default = TorchVerifier(plan)  # the default: aggregate subgroup mode, device cuda
    gen = torch.Generator().manual_seed(SEED)
    base = ("transcript", "pow_fr", "msm", "pairing")

    # (a) the default mode
    run_path("a default (hints, fused aggregate subgroup)",
             lambda: default.verify(proof_t, pis_t, hints_t, gen), hinted, base + ("decompress",))
    traced_timed("a", lambda: default.verify(proof_t, pis_t, hints_t, gen))

    # (b) the hintless aggregate mode (__graft_entry__.entry()'s path)
    run_path("b hintless aggregate", lambda: default.verify(proof_t, pis_t, None, gen), expected,
             base + ("sqrt_decode", "subgroup"))
    traced_timed("b", lambda: default.verify(proof_t, pis_t, None, gen))
    # (c) the hintless mode with the subgroup test off
    run_path("c hintless, subgroup off", lambda: verifier.verify(proof_t, pis_t), expected,
             base + ("sqrt_decode",))
    # the swapped row fails the subgroup test in the aggregate and exact
    # modes only (it also rejects through its changed transcript)
    for mode in ("aggregate", "exact", "off"):
        v_m = TorchVerifier(plan, subgroup_check=mode)
        valid = v_m.core(proof_t, pis_t, hints_t, v_m.subgroup_weights(gen))[2]
        if bool(valid[EVIL_ROW]) != (mode == "off"):
            _fail(f"core() in mode {mode}: all_valid of the non-subgroup row is {bool(valid[EVIL_ROW])}")
    print("[path] non-subgroup row: all_valid False in aggregate and exact modes, True in off mode")

    # (d) verify_rlc on the mixed batch: failing groups, re-checked rows
    rlc_needs = base + ("decompress",)
    suspects = []

    def rlc(v, proof_b, pis_b, hints_b, generator=gen):
        """verify_rlc's two legs, the suspect count kept: the re-check's
        pairing launches on every call, gated on the device by that count."""
        def run():
            out = v.verify_rlc_device(proof_b, pis_b, v.rlc_weights(proof_b.shape[0], generator), hints_b,
                                      group=8, generator=generator)
            suspects.append(int(out[1]))
            return v.rlc_finalize(*out)
        return run

    def check_gate(label, launches, dirty: bool):
        if (suspects[-1] > 0) != dirty or launches["pairing"] < 2:
            _fail(f"path {label}: {suspects[-1]} suspects, {launches['pairing']} pairing launches")

    launches_d = run_path("d verify_rlc group 8, mixed", rlc(default, proof_t, pis_t, hints_t), hinted, rlc_needs)
    check_gate("d", launches_d, True)
    if default.msm_term_counts != [16, 8]:  # the multi-open MSM, then the RLC aggregation
        _fail(f"path d ran MSMs of K = {default.msm_term_counts}, expected [16, 8]")
    # (e) an honest batch: the re-check gated off on the device; (e') one
    # corrupted hint
    honest_t = torch.from_numpy(np.stack([proof_h] * B)).to(dev)
    honest_hints = torch.from_numpy(verifier.compute_y_hints(np.stack([proof_h] * B))).to(dev)
    launches_e = run_path("e verify_rlc group 8, honest", rlc(default, honest_t, pis_t, honest_hints),
                          np.ones(B, bool), rlc_needs)
    check_gate("e", launches_e, False)
    traced_timed("e", lambda: default.verify_rlc(honest_t, pis_t, honest_hints, group=8, generator=gen))
    bad_hint = honest_hints.clone()
    bad_hint[B - 3, 0, 0] ^= 1
    want_e2 = np.ones(B, bool)
    want_e2[B - 3] = False
    check_gate("e'", run_path("e' verify_rlc group 8, one corrupted hint", rlc(default, honest_t, pis_t, bad_hint),
                              want_e2, rlc_needs), False)

    stamp("paths (a)-(e')")
    from plutus_halo2_tpu_torch.serving import ProofBundle, VerificationService

    # ---- 5b. the circuits: the GWC19 flavor, the lookup and ATMS circuits ------
    # Each batch: the honest proof, its committed invalid twin every 8th row,
    # a corrupted proof scalar (circuit_batch), and a corrupted y-hint on an
    # honest row, which only the hinted paths reject.
    def circuit_inputs(name):
        plan_s, proof_s, bad_s, pis_s = sets[name]
        v_s = set_verifier(name)
        scalar_off = list(v_s.layout.scalar_offsets.values())[0]
        batch_s, want_s = circuit_batch(proof_s, bad_s, scalar_off, B)
        t0 = time.perf_counter()
        hints_s = corrupt_hint(v_s.compute_y_hints(batch_s))
        hint_s = time.perf_counter() - t0
        hinted_s = want_s.copy()
        hinted_s[CIRCUIT_HINT_ROW] = False
        print(f"[circuit] {name}: {plan_s.flavor}, k = {plan_s.vk.k}, proof {v_s.layout.proof_len} bytes, "
              f"{len(v_s.layout.point_offsets)} points, squeezes {[l for _n, l in v_s.layout.squeezes]}; "
              f"compute_y_hints {hint_s * 1e3:.1f} ms at B={B}")
        return (v_s, torch.from_numpy(batch_s).to(dev),
                torch.from_numpy(v_s.encode_public_inputs([pis_s] * B)).to(dev),
                torch.from_numpy(hints_s).to(dev), want_s, hinted_s)

    def check_counts(label, v_s, want_k):
        if v_s.msm_term_counts != want_k:
            _fail(f"path {label} ran MSMs of K = {v_s.msm_term_counts}, expected {want_k}")

    # the new paths' own kernel inputs: while `keeping` is open, the
    # verifier's module sees a proxy of each ops module named, whose wrapper
    # keeps each call's arguments and output and calls the real one (so the
    # launch counts stay on the wrappers); `hold_plain` then holds every
    # kept output against the plain version on the same arguments
    from plutus_halo2_tpu_torch.models import verifier_torch

    sites = {"transcript": ("cuda_blake", "transcript_hashes", cuda_blake.transcript_hashes_plain),
             "sqrt_decode": ("cuda_curve", "decompress_hintless", tc.decompress),
             "subgroup": ("cuda_curve", "aggregate_subgroup_check", cuda_curve.aggregate_subgroup_check_plain)}

    class Proxy:
        def __init__(self, real):
            self.real = real

        def __getattr__(self, attr):
            return getattr(self.real, attr)

    @contextlib.contextmanager
    def keeping(*names):
        kept, reals = [], {}
        for n in names:
            mod_name, attr, _plain_fn = sites[n]
            if mod_name not in reals:
                reals[mod_name] = getattr(verifier_torch, mod_name)
                setattr(verifier_torch, mod_name, Proxy(reals[mod_name]))

            def keep(*args, _orig=getattr(reals[mod_name], attr), _n=n):
                out = _orig(*args)
                if not torch.cuda.is_current_stream_capturing():  # a capture computes nothing yet
                    kept.append((_n, args, out))
                return out
            setattr(getattr(verifier_torch, mod_name), attr, keep)
        try:
            yield kept
        finally:
            for mod_name, real in reals.items():
                setattr(verifier_torch, mod_name, real)
        missing = set(names) - {n for n, _a, _o in kept}
        if missing:
            _fail(f"kernels {sorted(missing)} kept no call")

    def hold_plain(label, kept):
        for n, args, out in kept:
            want, plain_ms = _plain(lambda: sites[n][2](*args))
            torch.cuda.synchronize()
            pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
            if not all(torch.equal(x, y) for x, y in pairs):
                _fail(f"path {label}: {n} kernel differs from its plain version on the path's inputs "
                      f"{tuple(args[0].shape)}")
            print(f"[path] {label}: {n} kernel on the path's {tuple(args[0].shape)} input exact against its "
                  f"plain version (plain {plain_ms:.1f} ms)")

    gv, g_proof, g_pis, g_hints, g_want, g_hinted = circuit_inputs("simple_mul_gwc19")
    # (f) GWC19, the default mode
    with keeping("transcript") as kept:
        run_path("f simple_mul GWC19 default (hints, fused aggregate subgroup)",
                 lambda: gv.verify(g_proof, g_pis, g_hints, gen), g_hinted, base + ("decompress",))
    hold_plain("f", kept)
    check_counts("f", gv, [3, 17])
    traced_timed("f", lambda: gv.verify(g_proof, g_pis, g_hints, gen))
    # (g) GWC19, the hintless aggregate mode
    with keeping("sqrt_decode", "subgroup") as kept:
        run_path("g simple_mul GWC19 hintless aggregate", lambda: gv.verify(g_proof, g_pis, None, gen), g_want,
                 base + ("sqrt_decode", "subgroup"))
    hold_plain("g", kept)
    check_counts("g", gv, [3, 17])
    traced_timed("g", lambda: gv.verify(g_proof, g_pis, None, gen))
    # (h) GWC19 verify_rlc on the mixed batch (failing groups re-checked) and
    # on an honest batch (no re-check)
    launches_h = run_path("h simple_mul GWC19 verify_rlc group 8, mixed", rlc(gv, g_proof, g_pis, g_hints),
                          g_hinted, rlc_needs)
    check_counts("h", gv, [3, 17, 8])
    check_gate("h", launches_h, True)
    g_honest = torch.from_numpy(np.stack([sets["simple_mul_gwc19"][1]] * B)).to(dev)
    g_honest_hints = torch.from_numpy(gv.compute_y_hints(g_honest.cpu().numpy())).to(dev)
    launches_h2 = run_path("h' simple_mul GWC19 verify_rlc group 8, honest",
                           rlc(gv, g_honest, g_pis, g_honest_hints), np.ones(B, bool), rlc_needs)
    check_counts("h'", gv, [3, 17, 8])
    check_gate("h'", launches_h2, False)
    # (i)-(l) the lookup and ATMS circuits in the default mode
    circuit_paths = {}
    for label, name, want_k, timed_p in (("i", "lookup_table", [19], True), ("j", "atms", [32], True),
                                         ("k", "atms_with_lookups", [36], True),
                                         ("l", "atms_228_408", [32], False)):
        cv, c_proof, c_pis, c_hints, c_want, c_hinted = circuit_inputs(name)
        circuit_paths[label] = (cv, c_proof, c_pis, c_hints, c_want, c_hinted, name)
        with keeping("transcript") as kept:
            run_path(f"{label} {name} default (hints, fused aggregate subgroup)",
                     lambda: cv.verify(c_proof, c_pis, c_hints, gen), c_hinted, base + ("decompress",))
        hold_plain(label, kept)
        check_counts(label, cv, want_k)
        if timed_p:
            traced_timed(label, lambda: cv.verify(c_proof, c_pis, c_hints, gen))

    def serve(label, plan_s, good, bad, inputs, batch_size, n, gated=False):
        """n submissions (the invalid twin at i % 13 == 5, a bit-flipped
        proof at i % 29 == 7, else honest; with `gated`, one more whose tag
        differs from the one its caller expects) through one
        VerificationService: every future must resolve to its verdict, in
        one full and one padded batch."""
        flip = bytearray(good)
        flip[100] ^= 0x40
        svc = VerificationService(plan_s, batch_size=batch_size, linger_s=1.0, rlc_group=8)
        try:
            t0 = time.perf_counter()
            subs, want = [], []
            for i in range(n):
                proof_b = bad if i % 13 == 5 else bytes(flip) if i % 29 == 7 else good
                bundle = ProofBundle(proof_b, inputs)
                subs.append((bundle, svc.submit(bundle)))
                want.append(proof_b == good)
            if gated:
                bundle = ProofBundle(good, inputs)
                subs.append((bundle, svc.submit(bundle, expected_tag=ProofBundle(bad, inputs).tag)))
                want.append(False)
            got = []
            for bundle, fut in subs:
                tag, ok = fut.result(timeout=600)  # an exception fails the run
                if tag != bundle.tag:
                    _fail(f"{label} serving: a future resolved with another bundle's tag")
                got.append(ok)
            secs = time.perf_counter() - t0
        finally:
            svc.close()
        if got != want:
            _fail(f"{label} serving: verdicts differ at "
                  f"{[i for i, (g, w) in enumerate(zip(got, want)) if g != w][:10]}")
        if svc.dispatches != 2:
            _fail(f"{label} serving: {svc.dispatches} dispatches, expected one full and one padded batch")
        print(f"[serve] {label}: {len(subs)} submissions, verdicts exact ({sum(want)} accept), "
              f"{svc.dispatches} dispatches, {secs:.2f} s")

    # GWC19 serving: a few hundred submissions, one full batch of B / 4 and
    # one padded
    g_plan, g_good, g_bad, g_inputs = sets["simple_mul_gwc19"]
    serve("simple_mul GWC19", g_plan, bytes(g_good), bytes(g_bad), tuple(g_inputs), B // 4, B // 4 + B // 24)

    stamp("circuits phase")

    # ---- 5c. the programs: verify() and verify_rlc_device() as CUDA graphs ------
    # Each path's program (captured on its first call above, or here) replayed
    # on alternating batches (the path's own, another, its own again, so that
    # a stale static buffer shows), each call beside the eager form on the
    # same batch and weights: verdicts equal to each other and to the
    # expected vector, launches (the replay's accounting) equal to the eager
    # call's
    from plutus_halo2_tpu_torch.ops.pairing import prepare_g2
    from plutus_halo2_tpu_torch.tools.pairing_probe import S as PROBE_S, check_rows

    t5c = time.perf_counter()
    strict = TorchVerifier(plan, subgroup_check="exact")
    honest_np = np.stack([proof_h] * B)
    H = (honest_t, pis_t, honest_hints, np.ones(B, bool))
    M = (proof_t, pis_t, hints_t, hinted)
    M_nh, H_nh = (proof_t, pis_t, None, expected), (honest_t, pis_t, None, np.ones(B, bool))
    G = (g_proof, g_pis, g_hints, g_hinted)
    G_h = (g_honest, g_pis, g_honest_hints, np.ones(B, bool))
    progs = {"a": (default, "verify", (M, H, M)), "b": (default, "verify", (M_nh, H_nh, M_nh)),
             "c": (verifier, "verify", (M_nh, H_nh, M_nh)), "strict": (strict, "verify", (M, H, M)),
             "d": (default, "rlc", (M, H, M)), "e": (default, "rlc", (H, M, H)),
             "e'": (default, "rlc", ((honest_t, pis_t, bad_hint, want_e2), M, (honest_t, pis_t, bad_hint, want_e2))),
             "f": (gv, "verify", (G, G_h, G)),
             "g": (gv, "verify", ((g_proof, g_pis, None, g_want), (g_honest, g_pis, None, np.ones(B, bool)),
                                  (g_proof, g_pis, None, g_want)))}
    for label in ("i", "j", "k"):
        cv, c_proof, c_pis, c_hints, _c_want, c_hinted, name = circuit_paths[label]
        c_honest = np.stack([sets[name][1]] * B)
        C = (c_proof, c_pis, c_hints, c_hinted)
        C_h = (torch.from_numpy(c_honest).to(dev), c_pis, torch.from_numpy(cv.compute_y_hints(c_honest)).to(dev),
               np.ones(B, bool))
        progs[label] = (cv, "verify", (C, C_h, C))

    def form(v, entry, batch, graphs: bool, seed: int):
        """One call of the path's entry point in the given form, its weights
        from `seed` (the same for both forms)."""
        proof_b, pis_b, hints_b, _want = batch
        g = torch.Generator().manual_seed(seed)
        v.graphs = graphs
        try:
            if entry == "verify":
                return v.verify(proof_b, pis_b, hints_b, sub_weights=v.subgroup_weights(g))
            return rlc(v, proof_b, pis_b, hints_b, g)()
        finally:
            v.graphs = True

    for label, (v, entry, batches) in progs.items():
        for k, batch in enumerate(batches):
            runs = {}
            for graphs in (True, False):
                out, launches, _s = counted(f"5c {label}", lambda: form(v, entry, batch, graphs, SEED + k),
                                            ("transcript", "pow_fr", "msm", "pairing"))
                runs[graphs] = (np.asarray(out.cpu() if torch.is_tensor(out) else out), launches)
            (g_out, g_l), (e_out, e_l) = runs[True], runs[False]
            if not (np.array_equal(g_out, e_out) and np.array_equal(g_out, batch[3])):
                _fail(f"programs {label}, batch {k}: the graph form's verdicts differ from the eager form's or "
                      f"the expected vector at rows {np.nonzero((g_out != e_out) | (g_out != batch[3]))[0][:10]}")
            if g_l != e_l:
                _fail(f"programs {label}, batch {k}: graph launches {g_l}, eager {e_l}")
        print(f"[programs] {label}: {entry} graph == eager == expected on 3 alternating batches "
              f"({int(batches[0][3].sum())}/{int(batches[1][3].sum())} accepted), launches a call {g_l}, "
              f"captures {v.programs.captures}, replays {v.programs.replays}")

    # the pairing kernel gated by the device flag, at the re-check's rows
    pp_probe = cuda_pairing.PreparedPair(prepare_g2(rc.g2_mul(rc.G2_GEN, PROBE_S)), prepare_g2(rc.G2_GEN))
    el_r, er_r, want_r = check_rows(RLC_ROWS, 5, dev)
    for flag in (1, 0):
        en = torch.tensor([flag], dtype=torch.int32, device=dev)
        got_r = cuda_pairing.pairing_check(el_r, er_r, pp_probe, enable=en)
        plain_r, plain_ms = _plain(lambda: cuda_pairing.pairing_check_plain(el_r, er_r, pp_probe, enable=en))
        if not (torch.equal(got_r, plain_r) and torch.equal(got_r, want_r if flag else torch.ones_like(want_r))):
            _fail(f"pairing kernel at enable {flag} differs from its plain version or the rows' construction")
        ms_r = _times(lambda: cuda_pairing.pairing_check(el_r, er_r, pp_probe, enable=en), "pairing_kernel", 5)
        print(f"[programs] pairing kernel at enable {flag}, {RLC_ROWS} rows: exact against the plain version "
              f"(plain {plain_ms:.1f} ms), {ms_r[0]:.4f} ms device, {ms_r[1]:.4f} ms per call")

    # walls, eager and graph alternating in this process, three calls each
    for label in ("a", "b", "e", "f", "j"):
        v, entry, batches = progs[label]
        walls = {True: [], False: []}
        for k in range(3):
            for graphs in (False, True):
                walls[graphs].append(timed(lambda: form(v, entry, batches[0], graphs, SEED + k), calls=1))
        e_ms, g_ms = (statistics.median(walls[f]) * 1e3 for f in (False, True))
        print(f"[programs] wall {label}: eager {e_ms:.1f} ms, graph {g_ms:.1f} ms per batch (medians of 3, "
              f"alternating; {B / e_ms * 1e3:.1f} and {B / g_ms * 1e3:.1f} proofs/s; eager "
              f"{' '.join(f'{w * 1e3:.1f}' for w in walls[False])}, graph "
              f"{' '.join(f'{w * 1e3:.1f}' for w in walls[True])})")
    pools = []
    for v in {id(v): v for v, _k, _b in progs.values()}.values():
        for key, nbytes in v.programs.pool_bytes().items():
            pools.append(nbytes)
            print(f"[programs] pool {nbytes / 2**20:9.1f} MiB  k = {v.plan.vk.k:2d} {key}")
    print(f"[programs] {len(pools)} programs hold {sum(pools) / 2**30:.2f} GiB of pools; "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved; phase 5c {time.perf_counter() - t5c:.1f} s")
    stamp("programs")

    # ---- 6. serving ----------------------------------------------------------
    serve("simple_mul", plan, bytes(proof_h), bytes(proof_bad), tuple(pis), B, B + B // 13, gated=True)

    stamp("serving")

    # ---- 6b. the spec verifier and its traces --------------------------------
    # the port's pure-Python spec (refimpl/verifier.py) on each set's honest
    # proof and invalid twin: the committed verdicts, the card's verify() on
    # the same rows, and the spec's el / er against core()'s el / -er
    from plutus_halo2_tpu_torch.refimpl.verifier import verify as spec_verify
    from plutus_halo2_tpu_torch.utils.tracing import device_traces, diff_traces, format_traces

    spec_sets = {"simple_mul": (plan, proof_h, proof_bad, pis, default),
                 **{n: (*sets[n], set_verifier(n)) for n in ("simple_mul_gwc19", "lookup_table")}}
    for name, (plan_s, good, bad_s, pis_s, v_s) in spec_sets.items():
        rows = np.stack([good, bad_s])
        t0 = time.perf_counter()
        spec = [spec_verify(plan_s, r.tobytes(), pis_s, collect_traces=True) for r in rows]
        spec_s = (time.perf_counter() - t0) / len(rows)
        rows_t = torch.from_numpy(rows).to(dev)
        pis_2 = torch.from_numpy(v_s.encode_public_inputs([pis_s] * 2)).to(dev)
        hints_2 = torch.from_numpy(v_s.compute_y_hints(rows)).to(dev)
        on_card = v_s.verify(rows_t, pis_2, hints_2, gen).cpu().tolist()
        if [ok for ok, _t in spec] != [True, False] or on_card != [True, False]:
            _fail(f"spec {name}: the spec's verdicts {[ok for ok, _t in spec]} and the card's {on_card} on "
                  f"[honest, invalid] are not [True, False]")
        dev_tr = device_traces(v_s, rows_t, pis_2, hints_2, v_s.subgroup_weights(gen))
        diffs = [diff_traces(t, d) for (_ok, t), d in zip(spec, dev_tr)]
        if diffs[0] or "el" not in spec[0][1]:
            _fail(f"spec {name}: the honest row's traces differ from core()'s at {diffs[0]}")
        bad_note = (f"the spec's parse error: {spec[1][1]['parse_error']}" if "parse_error" in spec[1][1]
                    else f"el / er {'differ at ' + str(diffs[1]) if diffs[1] else 'match core(): the pairing rejects it'}")
        print(f"[spec] {name}: verdicts [True, False] from the spec ({spec_s:.2f} s a proof) and the card; "
              f"el / er of the honest row equal core()'s; the invalid row: {bad_note}")
    print("[spec] simple_mul's honest traces (format_traces):")
    for line in format_traces(spec_verify(plan, proof_h.tobytes(), pis, collect_traces=True)[1]).splitlines():
        print(f"[spec]   {line}")

    # ---- 6c. the exporters: every committed set round-trips byte for byte -----
    for name in artifacts.SETS:
        files = artifacts.read_set(name)
        proof_b = bytes.fromhex(files["proof.hex"].strip())
        pis_s = serialization.parse_public_inputs(files["public_input.hex"])
        out = {"proof.hex": serialization.export_proof(proof_b),
               "proof_invalid.hex": serialization.export_proof(bytes.fromhex(files["proof_invalid.hex"])),
               "public_input.hex": serialization.export_public_inputs(pis_s),
               "vk.json": serialization.vk_to_json(serialization.vk_from_json(files["vk.json"]))}
        if "proof.json" in files:
            out["proof.json"] = serialization.serialize_proof(proof_b)
        bad_files = [s for s, text in out.items() if text != files[s]]
        if bad_files:
            _fail(f"exporters: {name}'s {bad_files} differ from the committed files")
        print(f"[export] {name}: {sorted(out)} byte for byte")

    # ---- 6d. the submit tool, on the card ---------------------------------------
    from plutus_halo2_tpu_torch.tools import submit

    got_sub, launches, first_s = counted("submit", lambda: submit.main(["--copies", "12", "--batch", "8"]),
                                         base + ("decompress",))
    if [ok for _tag, ok in got_sub] != [i % 3 != 2 for i in range(12)]:
        _fail(f"submit: verdicts {[ok for _tag, ok in got_sub]}, every third should be rejected")
    print(f"[submit] 12 submissions, every third tampered: verdicts exact, launches {launches}, {first_s:.2f} s")

    stamp("spec, exporters, submit")

    # ---- 6e. the mesh: batch DP, dp x mp with the point-sharded MSM -----------
    # a virtual mesh of four entries of the card (every card where there are
    # several); the legs of __graft_entry__.dryrun_multichip, each counted
    # and its verdicts held against the expected vector of path (b)'s rows
    import tempfile

    import torch.distributed as dist

    from plutus_halo2_tpu_torch.parallel import mesh as pm

    n_cards = torch.cuda.device_count()
    mesh_devs = [torch.device("cuda", i) for i in range(n_cards)] if n_cards > 1 else [dev] * 4
    flat = pm.make_mesh(mesh_devs)
    grid = pm.make_mesh_2d(dp=len(mesh_devs) // 2, mp=2, devices=mesh_devs)
    print(f"[mesh] {flat}; {grid}")
    hintless = base + ("sqrt_decode", "subgroup")
    wall_b2 = timed(lambda: default.verify(proof_t, pis_t, None, gen))
    print(f"[mesh] path (b) in this phase: {wall_b2 * 1e3:.1f} ms per batch (median of 3)")
    lv, l_proof, l_pis, _l_hints, l_want, _l_hinted = circuit_inputs("lookup_table")
    kv, k_proof, k_pis, _k_hints, k_want, _k_hinted = circuit_inputs("atms_with_lookups")
    # (label, verifier, expected verdicts, MSM launches, multi-open K, the leg)
    legs = (("1 data_parallel_verify, simple_mul", default, expected, flat.size, [16],
             lambda: pm.data_parallel_verify(default, flat, proof_t, pis_t, sub_rng=gen)),
            ("1h data_parallel_verify with y-hints, simple_mul", default, hinted, flat.size, [16],
             lambda: pm.data_parallel_verify(default, flat, proof_t, pis_t, sub_rng=gen, y_hints=hints_t)),
            ("2 verify_2d dp x mp, simple_mul", default, expected, grid.size, [16],
             lambda: pm.verify_2d(default, grid, proof_t, pis_t, sub_rng=gen)),
            ("3 data_parallel_verify, lookup_table", lv, l_want, flat.size, [19],
             lambda: pm.data_parallel_verify(lv, flat, l_proof, l_pis, sub_rng=gen)),
            ("3k data_parallel_verify, atms_with_lookups", kv, k_want, flat.size, [36],
             lambda: pm.data_parallel_verify(kv, flat, k_proof, k_pis, sub_rng=gen)))
    for label, v_l, want_l, n_msm, want_k, fn in legs:
        launches = run_path(f"mesh {label}", fn, want_l, base + ("decompress",) if "hints" in label else hintless)
        k_l = v_l.msm_term_counts
        if (launches["msm"], k_l) != (n_msm, want_k):
            _fail(f"mesh {label}: {launches['msm']} MSM launches at K = {k_l}, expected {n_msm} at {want_k}")
        wall_l = timed(fn)
        print(f"[mesh] leg {label}: {wall_l * 1e3:.1f} ms per batch (median of 3; path (b) {wall_b2 * 1e3:.1f} ms), "
              f"multi-open K = {k_l}, {launches['msm']} MSM launches")
    if default.msm is not cuda_curve.msm:
        _fail("verify_2d left the MSM hook set")

    # the point-sharded MSM at simple_mul's K = 16 and ATMS's 32 and 36 (and
    # GWC19's 17), on the kernel phase's random rows: shard_map_msm over mp 2
    # and 4 entries of the card and sharded_msm over the flat mesh, in affine
    # coordinates against the unsharded kernel; the mp-2 slice held against
    # the plain versions (msm_check: limb for limb, and the per-point prefix
    # sums) and its device time beside the unsharded kernel's
    for k, (pts_k, sc_k) in {16: (pts, sc), **{k: (pts_c[:, :k].contiguous(), sc_c[:, :k].contiguous())
                                               for k in (17, 32, 36)}}.items():
        whole = cuda_curve.msm(pts_k, sc_k)
        whole_a = tc.to_affine(whole)
        for mp in (2, 4):
            got_a = tc.to_affine(pm.shard_map_msm(pts_k, sc_k, pm.make_mesh([dev] * mp, axis="mp")))
            if not all(torch.equal(x, y) for x, y in zip(got_a, whole_a)):
                _fail(f"shard_map_msm at ({B}, {k}) over mp {mp} differs from the unsharded kernel")
        one = pm.sharded_msm(pm.make_mesh(mesh_devs, axis="shard"), pts_k[0], sc_k[0])
        if not all(torch.equal(x, y) for x, y in zip(tc.to_affine(one[None]), tc.to_affine(whole[:1]))):
            _fail(f"sharded_msm at K = {k} differs from the unsharded kernel")
        k0 = -(-k // 2)
        pts_h, sc_h = pts_k[:, :k0].contiguous(), sc_k[:, :k0].contiguous()
        msm_check(pts_h, sc_h, ref=None if k == 16 else refs[k0])  # K = 16: pts' own per-point MSM
        t_whole = _times(lambda: cuda_curve.msm(pts_k, sc_k), "msm_kernel", 10)
        last = WINDOW["last"]  # the device time against the CUDA events around the same 10 calls
        print(f"[timer] msm K = {k} window: {last['calls']} calls, {last['device_ms']:.4f} ms of MSM kernels "
              f"({last['busy_ms']:.4f} of all) in {last['event_ms']:.4f} ms of CUDA events "
              f"({last['device_ms'] / last['event_ms']:.4f}; {last['host_ms']:.4f} ms enqueueing), "
              f"{last['fillers']} fillers")
        t_half = _times(lambda: cuda_curve.msm(pts_h, sc_h), "msm_kernel", 10)
        mesh2 = pm.make_mesh([dev] * 2, axis="mp")
        call2 = _call_ms(lambda: pm.shard_map_msm(pts_k, sc_k, mesh2), 5)
        b_whole, b_half = msm_bound(pts_k, sc_k), msm_bound(pts_h, sc_h)
        print(f"[mesh] msm K = {k}: shard_map_msm over mp 2 and 4 and sharded_msm (K over {flat.size}) equal the "
              f"unsharded kernel in affine; device {t_whole[0]:.4f} ms at ({B}, {k}) (bound {b_whole[0]:.5f}), "
              f"{t_half[0]:.4f} ms at the mp-2 slice ({B}, {k0}) (exact against the plain versions; bound "
              f"{b_half[0]:.5f}); per call "
              f"{t_whole[1]:.4f} ms unsharded, {call2:.4f} ms for shard_map_msm over mp 2 (two slices and the "
              f"point-add tree)")

    # init_distributed at world size 1 (NCCL): a mesh over the process group,
    # the DP leg through its collectives, and sharded_msm over the group's
    # mesh (its entries all in this process: no collective)
    with tempfile.TemporaryDirectory() as store:
        dev_d = pm.init_distributed(f"file://{os.path.join(store, 'store')}", world_size=1, rank=0)
        try:
            dmesh = pm.make_mesh([dev_d] * 2)
            print(f"[mesh] process group: backend {dist.get_backend()}, world size {dist.get_world_size()}, "
                  f"{dmesh}")
            run_path("mesh 1' data_parallel_verify over the process group", lambda: pm.data_parallel_verify(
                default, dmesh, proof_t, pis_t, sub_rng=gen), expected, hintless)
            for k, (pts_k, sc_k) in ((16, (pts, sc)), (36, (pts_c[:, :36].contiguous(), sc_c[:, :36].contiguous()))):
                one = pm.sharded_msm(pm.make_mesh([dev_d] * 2, axis="shard"), pts_k[0], sc_k[0])
                if not all(torch.equal(x, y) for x, y in zip(tc.to_affine(one[None]),
                                                             tc.to_affine(cuda_curve.msm(pts_k[:1], sc_k[:1])))):
                    _fail(f"sharded_msm over the process group's mesh at K = {k} differs from the unsharded kernel")
            print("[mesh] sharded_msm over the process group's mesh at K = 16 and 36 (one process: no "
                  "collective) equals the unsharded kernel in affine")
        finally:
            dist.destroy_process_group()

    stamp("mesh")
    report_refusals("mesh")

    # ---- 7. the probe path ------------------------------------------------------
    from plutus_halo2_tpu_torch.tools import mma_probe, perf_probe

    out_dir = os.path.join(root, "chiprun_out")  # listed in .gitignore
    probe_stages = ["mul", "decompress", "sqrtp", "msmp", "msmp5", "subk", "pairingp", "verifyh"]
    _, launches, first_s = counted("probes", lambda: (
        mma_probe.main([str(B)]),
        perf_probe.main([str(PROBE_BATCH), *probe_stages, "--trace", os.path.join(out_dir, "trace_probe")]),
    ), counters)
    print(f"[probe] tensor-core probe at B={B} and stage probe at B={PROBE_BATCH} ({' '.join(probe_stages)}): "
          f"every check exact, launches {launches}, {first_s:.1f} s")

    stamp("probe path")

    # ---- 8. trace: the card's busy share of one default-mode batch ----------------
    # in the graph form (the replay of path (a)'s program) and the eager form
    # (graphs off for the call), each beside its untraced wall
    for form_name, graphs, trace_dir in (("graph", True, "trace_verify"), ("eager", False, "trace_verify_eager")):
        default.graphs = graphs
        try:
            wall_u = timed(lambda: default.verify(proof_t, pis_t, hints_t, gen))
            with torch_trace(os.path.join(out_dir, trace_dir)) as trace_path:
                t0 = time.perf_counter()
                default.verify(proof_t, pis_t, hints_t, gen)
                torch.cuda.synchronize()
                traced_s = time.perf_counter() - t0
        finally:
            default.graphs = True
        busy, window = device_busy_us(trace_path)  # raises if the profiler saw no device activity
        by_name = device_time_by_name(trace_path)
        print(f"[trace] {form_name} form: device busy share of one default-mode verify() at B={B}: "
              f"{busy / window:.4f} ({busy / 1e3:.3f} ms busy in a {window / 1e3:.3f} ms traced window; the "
              f"traced call {traced_s * 1e3:.1f} ms, the untraced median of 3 {wall_u * 1e3:.1f} ms, so busy over "
              f"untraced {busy / 1e3 / (wall_u * 1e3):.4f}; {os.path.relpath(trace_path, root)})")
        print(f"[trace] {form_name} form: {sum(c for _n, c, _us in by_name)} device activities of {len(by_name)} "
              f"kinds; the most time:")
        for name, count, us in by_name[:8]:
            print(f"[trace]   {us / 1e3:9.3f} ms in {count:5d} x {name[:100]}")

    stamp("trace")

    # ---- 9. bench: entry(), dryrun_multichip(4), the port's bench ----------------
    from plutus_halo2_tpu_torch import bench
    from plutus_halo2_tpu_torch import entry as entry_mod

    t9 = time.perf_counter()
    fn_e, args_e = entry_mod.entry()
    run_path("entry() (hintless aggregate, batch 4)", lambda: fn_e(*args_e), np.ones(4, bool), hintless)
    legs9, launches, first_s = counted("dryrun_multichip(4)", lambda: entry_mod.dryrun_multichip(4), hintless)
    if set(legs9) != {"dp", "dp_x_mp", "atms_with_lookups"} or "SKIPPED" in legs9.values():
        _fail(f"dryrun_multichip(4) did not run all three legs: {legs9}")
    print(f"[bench] dryrun_multichip(4) on the virtual mesh: three legs, verdicts exact, "
          f"launches {launches}, {first_s:.1f} s")
    bench_args = ["--batch", str(B), "--rows", "all", "--iters", "3",
                  "--out", os.path.join(out_dir, "bench_details.json")]
    rows9, launches, first_s = counted("bench", lambda: bench.main(bench_args),
                                       base + ("decompress", "sqrt_decode", "subgroup"))
    # the bench's K = 64 MSM (held there against the plain windowed MSM and
    # the spec on these tensors): its device time beside its bound
    pts64, sc64, _host64, _scal64 = bench.msm_inputs(B, dev)
    got64 = cuda_curve.msm(pts64, sc64)
    want64, plain64 = _plain(lambda: tc.msm_windowed(pts64, sc64))
    if not torch.equal(got64, want64):
        _fail(f"MSM kernel at ({B}, {bench.MSM_K}) differs from the plain windowed MSM limb for limb")
    t64 = _times(lambda: cuda_curve.msm(pts64, sc64), "msm_kernel", 10)
    b64 = msm_bound(pts64, sc64)
    print(f"[bench] msm at ({B}, {bench.MSM_K}): exact limb for limb (plain {plain64:.3f} ms), {t64[0]:.4f} ms "
          f"device, {t64[1]:.4f} ms per call, bound {b64[0]:.5f} ms by {b64[1]} (ratio {t64[0] / b64[0]:.1f})")
    if rows9[-1]["metric"] != bench.HEADLINE or len(rows9) != 17:
        _fail(f"bench emitted {[r['metric'] for r in rows9]}")
    print(f"[bench] {len(rows9)} rows at B = {B} (bench.main {' '.join(bench_args)}), launches {launches}, "
          f"{first_s:.1f} s:")
    print(f"[bench]   {'metric':<66} {'value':>12} {'steady s':>9} {'latency s':>9} {'warmup s':>9}  msm_terms")
    for r in rows9:
        print(f"[bench]   {r['metric']:<66} {r['value']:12.1f} {r['steady_state_sec']:9.4f} "
              f"{r.get('latency_sec', float('nan')):9.4f} {r['warmup_sec']:9.4f}  {r.get('msm_terms', r.get('K'))}")
    print(f"[bench] phase 9: {time.perf_counter() - t9:.1f} s")

    stamp("bench")

    # ---- 10. prove: the Fr polynomial kernels, keygen and prove on the card ------
    prove_phase(dev, rng, results, record, counters, counted, _times, _plain, stamp)

    report_refusals("the rest of the run")
    print(f"[timer] device_ms's windows open with {WINDOW['fillers']} filler kernels (raised {WINDOW['raised']} "
          f"times, {len(WINDOW['refused'])} windows refused)")
    ecc_after, xid = _health()
    print(f"[health] ECC after the run: {ecc_after} (before: {ecc_before})")
    print(f"[health] Xid: {xid}")
    print(json.dumps({"kernels": [results[n] for n in (
        "transcript", "pow_fr", "pow_fp", "sqrt_decode", "msm", "pairing", "decompress", "subgroup", "mont_mul",
        "int8_dot", "int8_chain", "bf16_chain", "fr_glue") + POLY_KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
