"""Block-size sweep of the kernels on one GPU.

    python3 -m plutus_halo2_tpu_torch.block_sweep [--batch 1024] [--reps 5]

    python3 -m plutus_halo2_tpu_torch.block_sweep --only msm,decompress_fused

Times the unfused hinted decompression kernel at the verifier's shape
(B x 10 points) by device time (``utils.profiling.device_ms``), at the
default block size (``ops._build.BLOCK_THREADS``) and at fixed sizes from 1
to 128 threads, checks that every size gives the default's output, and
prints one JSON line with the device ms per size. The lane-group kernels
are swept over lanes per row and rows per block (0: the fewest that fill
the SMs once), each setting's output checked against the default's: the
transcript kernel (1, 4 lanes a compression x 0, 1, 2, 4, 8, 16 rows, a
group a squeeze) at (B, simple_mul's 9 squeeze lengths); the bf16 chain (1, 2, 4, 8 warps a block) at 200 steps on B columns; the
pairing
(16, 32 lanes x 1, 2, 4, 8 rows) at B and at the RLC group check's B / 8
rows; the MSM (4, 8, 16, 32 lanes x 0, 1, 2, 4, 8 rows) at (B, 16) and at
the RLC aggregation's (B / 4, 8); the fused decompress and the aggregate
subgroup kernel (the same grid) at (B, 10), one round; the pow kernel
(lanes per element: Fr 2, 4, 8, Fp 2, 4; x 4, 8, 16, 32 elements per
block) at the Fr inversion's (B, 1) and the Fp square-root ladder's
(B, 10). ``--only`` picks some of transcript, bf16_chain, pow_fr, pow_fp,
decompress, subgroup, pairing, msm, decompress_fused. Last, it prints the
card's ``nvidia-smi`` name and power limit. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .ops import _build, cuda_blake, cuda_curve, cuda_field, cuda_mma, cuda_pairing
from .ops import curve as tc
from .ops import pairing as tp
from .ops.limb import FP_SPEC, FR_SPEC
from .refimpl import curve as rc
from .utils.profiling import device_ms

SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
PAIRING_LANES = (16, 32)
PAIRING_ROWS = (1, 2, 4, 8)
GROUP_LANES = (4, 8, 16, 32)  # the MSM's, fused decompress and subgroup kernels' lanes per row
GROUP_ROWS = (0, 1, 2, 4, 8)  # and rows per block (0: from B)
POW_LANES = {"pow_fr": (2, 4, 8), "pow_fp": (2, 4)}  # lanes per element of the pow kernel
POW_ROWS = (4, 8, 16, 32)  # and elements per block
TRANSCRIPT_LANES = (1, 4)  # lanes a compression of the transcript kernel
TRANSCRIPT_ROWS = (0, 1, 2, 4, 8, 16)  # and rows per block (0: from B)
CHAIN_WARPS = (1, 2, 4, 8)  # warps a block of the bf16 chain
PARTS = ("transcript", "bf16_chain", "pow_fr", "pow_fp", "decompress", "subgroup", "pairing", "msm",
         "decompress_fused")
# the squeeze lengths of simple_mul's transcript (models/layout.py)
SIMPLE_MUL_LENGTHS = (264, 265, 266, 463, 562, 1124, 1125, 1175, 1275)


def _canon(spec, shape, rng, dev):
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N for _ in range(n)]
    return torch.from_numpy(np.stack([spec.encode(v) for v in vals]).reshape(*shape, spec.L)).to(dev)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _pairing_sweep(el, er, pp, reps: int):
    """The pairing kernel's device ms per (lanes per row, rows per block) at
    B rows and at B / 8, each setting's verdicts checked against the
    default's."""
    default = cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK
    for n in (el.shape[0], el.shape[0] // 8):
        el_n, er_n = el[:n].contiguous(), er[:n].contiguous()
        fn = lambda: cuda_pairing.pairing_check(el_n, er_n, pp)  # noqa: E731
        want = fn()
        ms = {}
        try:
            for lanes in PAIRING_LANES:
                for rows in PAIRING_ROWS:
                    cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK = lanes, rows
                    if not torch.equal(fn(), want):
                        raise SystemExit(f"block_sweep: pairing at {lanes} lanes, {rows} rows per block differs")
                    ms[f"{lanes}x{rows}"] = device_ms(fn, ["pairing_kernel"], reps)
        finally:
            cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK = default
        print(json.dumps({"kernel": "pairing", "items": n, "default": f"{default[0]}x{default[1]}",
                          "ms_by_lanes_x_rows": ms}))


def _group_sweep(name: str, fn, kernel: str, lanes_attr: str, rows_attr: str, items: int, reps: int,
                 module=cuda_curve, lanes_grid=GROUP_LANES, rows_grid=GROUP_ROWS):
    """Device ms of a lane-group kernel (its lanes and rows constants in
    `module`) per (lanes per row, rows per block), each setting's output
    checked against the default's."""
    default = getattr(module, lanes_attr), getattr(module, rows_attr)
    want = fn()
    ms = {}
    try:
        for lanes in lanes_grid:
            for rows in rows_grid:
                setattr(module, lanes_attr, lanes)
                setattr(module, rows_attr, rows)
                if not _same(fn(), want):
                    raise SystemExit(f"block_sweep: {name} at {lanes} lanes, {rows} rows per block differs")
                ms[f"{lanes}x{rows}"] = device_ms(fn, [kernel], reps)
    finally:
        setattr(module, lanes_attr, default[0])
        setattr(module, rows_attr, default[1])
    print(json.dumps({"kernel": name, "items": items, "default": f"{default[0]}x{default[1]}",
                      "ms_by_lanes_x_rows": ms}))


def _chain_sweep(B: int, reps: int):
    """The bf16 chain's device ms per warps a block at 200 steps on the JAX
    probe's inputs, each output checked against the exact plain chain."""
    rng = np.random.default_rng(0)
    mat = torch.from_numpy(rng.integers(0, 127, (cuda_mma.M, cuda_mma.K)).astype(np.int8)).cuda()
    vec = torch.from_numpy(rng.integers(0, 127, (cuda_mma.K, B)).astype(np.int8)).cuda()
    want = cuda_mma.chain_plain(mat.cpu(), vec.cpu()).cuda()
    fn = lambda: cuda_mma.bf16_chain(mat, vec)  # noqa: E731
    default, ms = cuda_mma.CHAIN_WARPS, {}
    try:
        for warps in CHAIN_WARPS:
            cuda_mma.CHAIN_WARPS = warps
            if not torch.equal(fn(), want):
                raise SystemExit(f"block_sweep: bf16_chain at {warps} warps a block differs")
            ms[warps] = device_ms(fn, ["bf16_chain_kernel"], reps)
    finally:
        cuda_mma.CHAIN_WARPS = default
    print(json.dumps({"kernel": "bf16_chain", "items": B, "steps": cuda_mma.STEPS, "default": default,
                      "ms_by_warps": ms}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--only", default=",".join(PARTS), help="comma-separated parts to run")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(PARTS):
        raise SystemExit(f"block_sweep: --only takes some of {','.join(PARTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("block_sweep: needs a CUDA device")
    dev, B = torch.device("cuda"), args.batch
    rng = np.random.default_rng(args.seed)

    buf = torch.from_numpy(rng.integers(0, 256, size=(B, max(SIMPLE_MUL_LENGTHS) + 49),
                                        dtype=np.uint8)).to(dev)
    x_fr = _canon(FR_SPEC, (B, 1), rng, dev)
    x_fp = _canon(FP_SPEC, (B, 10), rng, dev)
    # random G1 points [a]G and [b]G per row
    gen = torch.from_numpy(tc.host_point_to_mont(rc.G1_GEN)).to(dev)
    sides = cuda_curve.msm(gen.expand(2 * B, 1, 3, FP_SPEC.L).contiguous(),
                           _canon(FR_SPEC, (2 * B, 1), rng, dev))
    el, er = sides[:B].contiguous(), sides[B:].contiguous()
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, 0xC0FFEE)),
                                   tp.prepare_g2(rc.G2_GEN))
    # compressed G1 points with their y-hints: a pool of 16, tiled
    pool = [rc.g1_mul(rc.G1_GEN, int(k)) for k in rng.integers(1, 2**62, size=16)]
    pick = rng.integers(0, len(pool), size=(B, 10))
    raw = torch.from_numpy(np.stack([np.frombuffer(rc.g1_compress(p), np.uint8) for p in pool])[pick]).to(dev)
    hints = torch.from_numpy(np.stack([FP_SPEC.encode(p[1]) for p in pool])[pick]).to(dev)
    sub_w = tc.subgroup_weights(10, 1, torch.Generator().manual_seed(args.seed))
    pts = cuda_curve.decompress_hinted(raw, hints)[0]
    if "transcript" in only:
        transcript = lambda: cuda_blake.transcript_hashes(buf, SIMPLE_MUL_LENGTHS)  # noqa: E731
        if not _same(transcript(), cuda_blake.transcript_hashes_plain(buf, SIMPLE_MUL_LENGTHS)):
            raise SystemExit("block_sweep: the transcript kernel differs from the plain Blake2b")
        _group_sweep("transcript", transcript, "transcript_kernel", "TRANSCRIPT_LANES", "TRANSCRIPT_ROWS", B,
                     args.reps, cuda_blake, TRANSCRIPT_LANES, TRANSCRIPT_ROWS)
    if "bf16_chain" in only:
        _chain_sweep(B, args.reps)
    if "decompress" in only:
        fn = lambda: cuda_curve.decompress_hinted(raw, hints)  # noqa: E731
        default = _build.BLOCK_THREADS
        want = fn()
        default_ms = device_ms(fn, ["decompress_kernel"], args.reps)
        ms = {}
        try:
            for t in SIZES:
                _build.BLOCK_THREADS = t
                if not _same(fn(), want):
                    raise SystemExit(f"block_sweep: decompress at {t} threads per block differs")
                ms[t] = device_ms(fn, ["decompress_kernel"], args.reps)
        finally:
            _build.BLOCK_THREADS = default
        print(json.dumps({"kernel": "decompress", "items": 10 * B, "default_threads": default,
                          "default_ms": default_ms, "ms_by_threads": ms}))
    for name, n, fn, lanes_attr in (
        ("pow_fr", B, lambda: cuda_field.fr_pow(x_fr, FR_SPEC.N - 2), "POW_FR_LANES"),
        ("pow_fp", 10 * B, lambda: cuda_field.fp_pow(x_fp, (FP_SPEC.N + 1) >> 2), "POW_FP_LANES"),
    ):
        if name in only:
            _group_sweep(name, fn, "pow_kernel", lanes_attr, "POW_ROWS", n, args.reps, cuda_field,
                         POW_LANES[name], POW_ROWS)
    if "subgroup" in only:
        _group_sweep("subgroup", lambda: cuda_curve.aggregate_subgroup_check(pts, sub_w), "subgroup_kernel",
                     "SUBGROUP_LANES", "SUBGROUP_ROWS", B, args.reps)
    if "pairing" in only:
        _pairing_sweep(el, er, pp, args.reps)
    if "msm" in only:
        host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=16)] + [None]
        tab = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in host])).to(dev)
        for rows, K in ((B, 16), (B // 4, 8)):
            pts_m = tab[torch.from_numpy(rng.integers(0, len(host), size=(rows, K))).to(dev)].contiguous()
            sc_m = _canon(FR_SPEC, (rows, K), rng, dev)
            _group_sweep(f"msm K={K}", lambda: cuda_curve.msm(pts_m, sc_m), "msm_kernel", "MSM_LANES", "MSM_ROWS",
                         rows, args.reps)
    if "decompress_fused" in only:
        _group_sweep("decompress_fused", lambda: cuda_curve.decompress_hinted(raw, hints, sub_w),
                     "decompress_subgroup_kernel", "DECOMPRESS_LANES", "DECOMPRESS_ROWS", 10 * B, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
