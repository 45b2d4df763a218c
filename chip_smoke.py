#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path — exact, hintless ``TorchVerifier.verify()``
of the simple_mul circuit (halo2-book KZG, subgroup_check="off") at the
headline batch B = 1024 — through its hand-written CUDA kernels, in phases:

  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit, its ECC counters and the kernel log's Xid lines (again at the end);
  2. build: nvcc builds every kernel from ``plutus_halo2_tpu_torch/csrc``;
  3. field: the Fp and Fr Montgomery-product test kernel against the plain
     PyTorch product on 2^16 random canonical pairs (exactly equal);
  4. kernels: transcript, Fr pow, Fp pow, MSM and pairing against their
     plain PyTorch versions at the main path's shapes (exactly equal; the
     MSM in affine coordinates; the pairing on 1024 distinct checks built
     from the slice's pairing sides, half of them true), with CUDA-event
     times and the least time the functions' operations need;
  5. the slice: a B = 1024 batch of the committed simple_mul proof, its
     committed tampered twin and one bit-flipped row; verdicts must equal
     the expected vector and every kernel must have launched.

Prints one ``{"kernels": [...]}`` line, then the card line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

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


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _median_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(int_ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
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


def _pairing_fp_products(n_live: int, fp_inv: int, x_abs: int) -> int:
    """Fp products of one pairing-check row with n_live non-identity points
    (fp_inv: products of one Fermat inversion; x_abs: |BLS x|)."""
    if n_live == 0:
        return 0  # e(O, Q1) e(O, Q2) = 1: nothing to compute
    n_sq, n_add = x_abs.bit_length() - 1, bin(x_abs).count("1") - 1
    affine = n_live * (fp_inv + 2)
    miller = (n_sq - 1) * FP12_SQR + n_live * (n_sq + n_add) * LINE  # f = 1 needs no first squaring
    fp6_inv = 12 * FP2_MUL + 4 + fp_inv
    fp12_inv = 24 * FP2_MUL + fp6_inv
    easy = fp12_inv + FP12_MUL + FROB + FP12_MUL
    exp_by_x = n_sq * CYC_SQR + n_add * FP12_MUL
    hard = 5 * exp_by_x + 2 * FP12_MUL + (FROB + FP12_MUL) + (FROB + 2 * FP12_MUL) + (CYC_SQR + 2 * FP12_MUL)
    return affine + miller + easy + hard


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


def _blake_ops(lengths) -> int:
    comps = max((l - 1) // 128 for l in lengths) + 2 * len(lengths)
    return comps * 12 * 8 * 32  # 96 G steps of ~16 64-bit ops, 2 int32 ops each


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
    from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier
    from plutus_halo2_tpu_torch.ops import _build, cuda_blake, cuda_curve, cuda_field, cuda_pairing
    from plutus_halo2_tpu_torch.ops import curve as tc
    from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC, limbs_to_int, window_digits
    from plutus_halo2_tpu_torch.refimpl import curve as rc
    from plutus_halo2_tpu_torch.refimpl.field import BLS_X, Q
    from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk
    from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json

    dev = torch.device("cuda")
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

    def rand_canon(spec, shape):
        """Random canonical values < N as (shape..., L) limb tensors."""
        n = int(np.prod(shape))
        raw = rng.integers(0, 256, size=(n, 2 * spec.L), dtype=np.uint8)
        vals = [int.from_bytes(r.tobytes(), "little") % spec.N for r in raw]
        limbs = np.frombuffer(b"".join(v.to_bytes(2 * spec.L, "little") for v in vals),
                              dtype=np.uint16).astype(np.int64)
        return torch.from_numpy(limbs.reshape(*shape, spec.L)).to(dev)

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

    # ---- the slice's inputs --------------------------------------------
    art = os.path.join(root, "examples", "artifacts")
    with open(os.path.join(art, "simple_mul_vk.json")) as f:
        vk = vk_from_json(f.read())
    proofs = {}
    for name in ("proof", "proof_invalid"):
        with open(os.path.join(art, f"simple_mul_{name}.hex")) as f:
            proofs[name] = np.frombuffer(bytes.fromhex(f.read().strip()), np.uint8)
    with open(os.path.join(art, "simple_mul_public_input.hex")) as f:
        pis = parse_public_inputs(f.read())
    plan = plan_from_vk(SimpleMulCircuit(), vk)
    verifier = TorchVerifier(plan, subgroup_check="off")  # device defaults to cuda
    batch = np.stack([proofs["proof"]] * B).copy()
    expected = np.ones(B, bool)
    invalid_rows = np.arange(3, B, 8)
    batch[invalid_rows] = proofs["proof_invalid"]
    expected[invalid_rows] = False
    flip_row = 5
    batch[flip_row, 100] ^= 0x40
    expected[flip_row] = False
    proof_t = torch.from_numpy(batch).to(dev)
    pis_t = torch.from_numpy(verifier.encode_public_inputs([pis] * B)).to(dev)

    # ---- 4. kernel phases ------------------------------------------------
    results = {}

    def record(name, source, replaces, err, ms, plain_ms, bound):
        results[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "exact": err == 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        }
        print(f"[kernel] {name}: exact, {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
              f"by {bound[1]})")

    def limb_err(x, y):
        return int((x - y).abs().max()) if x.numel() else 0

    # transcript, on the batch's real transcript buffers
    lengths = [l for _n, l in verifier.layout.squeezes]
    buf = verifier.transcript_buffer(proof_t, pis_t)
    h1, h2 = cuda_blake.transcript_hashes(buf, lengths)
    p1, p2 = cuda_blake.transcript_hashes_plain(buf, lengths)
    torch.cuda.synchronize()
    if not (torch.equal(h1, p1) and torch.equal(h2, p2)):
        _fail("transcript kernel differs from the plain Blake2b")
    record("transcript", "plutus_halo2_tpu_torch/csrc/blake2b.cu",
           "plutus_halo2_tpu/ops/pallas_blake.py:82",
           max(limb_err(h1, p1), limb_err(h2, p2)),
           _median_ms(lambda: cuda_blake.transcript_hashes(buf, lengths), 20),
           _median_ms(lambda: cuda_blake.transcript_hashes_plain(buf, lengths), 3),
           _bound_ms(B * _blake_ops(lengths), buf.numel() + 8 * (h1.numel() + h2.numel())))

    # pow: the Fr inversion root (B, 1) and the Fp sqrt ladder (B, 10)
    n_pts = len(verifier.layout.point_offsets)
    for name, spec, shape, e, kern in (
        ("pow_fr", FR_SPEC, (B, 1), Q - 2, cuda_field.fr_pow),
        ("pow_fp", FP_SPEC, (B, n_pts), (FP_SPEC.N + 1) >> 2, cuda_field.fp_pow),
    ):
        x = rand_canon(spec, shape)
        got = kern(x, e)
        want = cuda_field.pow_plain(x, spec, e)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"{name} kernel differs from the plain pow")
        nw = 12 if spec is FP_SPEC else 8
        n = int(np.prod(shape))
        ops = 2 * n * _pow_products(window_digits(e)) * _cios_products(nw)
        record(name, "plutus_halo2_tpu_torch/csrc/pow.cu", "plutus_halo2_tpu/ops/pallas_field.py:32",
               limb_err(got, want), _median_ms(lambda: kern(x, e), 10),
               _median_ms(lambda: cuda_field.pow_plain(x, spec, e), 2),
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
    got = cuda_curve.msm(pts, sc)
    want = cuda_curve.msm_plain(pts, sc)
    ga, wa = tc.to_affine(got), tc.to_affine(want)
    torch.cuda.synchronize()
    if not (torch.equal(ga[2], wa[2]) and torch.equal(ga[0], wa[0]) and torch.equal(ga[1], wa[1])):
        _fail("MSM kernel differs from the plain MSM (affine)")
    live_pts = (pts[:, :, 2].abs().sum(-1) != 0).cpu().tolist()
    sc_ints = [[limbs_to_int(v) for v in row] for row in sc.cpu().numpy()]
    msm_products = sum(_msm_fp_products(s, l) for s, l in zip(sc_ints, live_pts))
    record("msm", "plutus_halo2_tpu_torch/csrc/msm.cu", "plutus_halo2_tpu/ops/pallas_curve.py:233",
           max(limb_err(ga[0], wa[0]), limb_err(ga[1], wa[1])),
           _median_ms(lambda: cuda_curve.msm(pts, sc), 10),
           _median_ms(lambda: cuda_curve.msm_plain(pts, sc), 1),
           _bound_ms(2 * msm_products * _cios_products(12),
                     8 * (pts.numel() + sc.numel() + B * 3 * FP_SPEC.L)))

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
    got = cuda_pairing.pairing_check(el, er, verifier.pair)
    want = cuda_pairing.pairing_check_plain(el, er, verifier.pair)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        _fail(f"pairing kernel differs from the plain pairing check on {int((got != want).sum())} rows")
    if not torch.equal(got, true_row):
        _fail("pairing verdicts differ from the rows' construction")
    live = (~tc.is_identity(el)).to(torch.int64) + (~tc.is_identity(er)).to(torch.int64)
    fp_inv = _pow_products(window_digits(FP_SPEC.N - 2))
    fp_products = sum(_pairing_fp_products(int(n), fp_inv, BLS_X) for n in live.tolist())
    record("pairing", "plutus_halo2_tpu_torch/csrc/pairing.cu",
           "plutus_halo2_tpu/ops/pallas_pairing.py:419", int((got != want).sum()),
           _median_ms(lambda: cuda_pairing.pairing_check(el, er, verifier.pair), 3),
           _median_ms(lambda: cuda_pairing.pairing_check_plain(el, er, verifier.pair), 1),
           _bound_ms(2 * fp_products * _cios_products(12), 8 * (el.numel() + er.numel()) + B))
    print(f"[kernel] pairing rows: {B} distinct checks, {int(true_row.sum())} true, "
          f"{int((~true_row).sum())} false")

    # ---- 5. the slice -----------------------------------------------------
    counters = {
        "transcript": cuda_blake.transcript_hashes, "pow_fr": cuda_field.fr_pow,
        "pow_fp": cuda_field.fp_pow, "msm": cuda_curve.msm, "pairing": cuda_pairing.pairing_check,
    }
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = verifier.verify(proof_t, pis_t)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if not np.array_equal(verdicts.cpu().numpy(), expected):
        _fail(f"verdicts differ from the expected vector at rows "
              f"{np.nonzero(verdicts.cpu().numpy() != expected)[0][:10].tolist()}")
    for name, n in launches.items():
        if n <= 0:
            _fail(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = n
    print(f"[slice] B={B}: verdicts exact ({int(expected.sum())} accept, {int((~expected).sum())} reject), "
          f"msm terms {verifier.msm_term_counts}, launches {launches}, first call {first_s:.3f} s")

    walls = []
    verifier.timings = {}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = verifier.verify(proof_t, pis_t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(v.cpu().numpy(), expected):
            _fail("verdicts changed between runs")
    wall = statistics.median(walls)
    print(f"[slice] {B / wall:.1f} proofs/s (median of 3 verify() calls: {wall * 1e3:.1f} ms per batch)")
    stage_ms = {name: statistics.median(s.elapsed_time(e) for s, e in evs)
                for name, evs in verifier.timings.items()}
    for name in ("transcript", "decompress", "fr_side", "msm", "pairing"):
        print(f"[slice] stage {name:<10} {stage_ms.get(name, float('nan')):9.3f} ms")
    other = wall * 1e3 - sum(stage_ms.values())
    print(f"[slice] stage {'other':<10} {other:9.3f} ms (multi-open scalar glue, parsing, host)")

    ecc_after, xid = _health()
    print(f"[health] ECC after the run: {ecc_after} (before: {ecc_before})")
    print(f"[health] Xid: {xid}")
    print(json.dumps({"kernels": [results[n] for n in ("transcript", "pow_fr", "pow_fp", "msm", "pairing")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
