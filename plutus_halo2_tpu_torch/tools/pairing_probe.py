"""Probe of the pairing kernel (``csrc/pairing.cu``) on one GPU.

    python3 -m plutus_halo2_tpu_torch.tools.pairing_probe [--rows 1024,128,64] [--check 1,17,64,128,129,1024]

Checks the kernel against its plain version (``cuda_pairing.pairing_check_plain``)
on B = 1, 17, 64, 128, 129 and 1024 rows of e([r]G, [s]G2) e([t]G, G2)
(true where t = -r s, the identity on either side in some rows, (O, O) in
row 0), at two lane-group widths; then, at each of --rows rows, prints each
row's phases in SM cycles from the kernel's ``clock64()`` marks (median
over the rows: the affine conversion, the Miller loop, the easy part, the
five chains, the tail; the cycles in stages of products, of linear
combinations and of inversions, and the stage count; the fastest and
slowest row, the median row with two points and with one), the median
two-point row's cycles per stage and per term of its critical path
(``pairing_program.program_stats()["row"]``: the terms its combinations
read), and the kernel's device ms (``utils.profiling.device_ms``) per (lanes
per row, rows per block); last the registers, stack and spills ``-Xptxas -v``
reported for pairing.cu's functions, and the card's ``nvidia-smi`` name and
power limit. A wrong verdict raises. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import _build, cuda_curve, cuda_pairing, pairing_program
from ..ops import curve as tc
from ..ops import pairing as tp
from ..ops.limb import FP_SPEC, FR_SPEC
from ..refimpl import curve as rc
from ..utils.profiling import device_ms

S = 0xC0FFEE
PHASES = ("affine", "miller", "easy", "chains", "tail")
STAGE_KINDS = ("product_stages", "linear_stages", "inversion_stages", "stages")
# (lanes per row, rows per block); None: cuda_pairing.rows_per_block's choice
CONFIGS = ((32, None), (32, 1), (32, 2), (32, 4), (32, 8), (16, 2), (16, 4), (16, 8))


def check_rows(B: int, seed: int, dev):
    """(el, er, want) for B rows: [r]G against [t]G with t = -r s on rows 0
    and 2 mod 4; r = 0 on row 0 and rows 7 mod 16, t = 0 on rows 5 mod 8."""
    rng = np.random.default_rng(seed)
    r = [int(x) for x in rng.integers(1, 2**62, size=B)]
    t = [int(x) for x in rng.integers(1, 2**62, size=B)]
    want = []
    for b in range(B):
        if b == 0 or b % 16 == 7:
            r[b] = 0
        if b % 4 in (0, 2):
            t[b] = (-r[b] * S) % FR_SPEC.N
        elif b % 8 == 5:
            t[b] = 0
        want.append(r[b] == 0 and t[b] == 0 or b % 4 in (0, 2))
    gen = torch.from_numpy(tc.host_point_to_mont(rc.G1_GEN)).to(dev)
    sc = torch.from_numpy(np.stack([FR_SPEC.encode(v) for v in r + t])).to(dev)
    sides = cuda_curve.msm_plain(gen.expand(2 * B, 1, 3, FP_SPEC.L).contiguous(), sc[:, None].contiguous())
    return sides[:B].contiguous(), sides[B:].contiguous(), torch.tensor(want, device=dev)


def ptxas_lines(source: str) -> list[str]:
    """The ``-Xptxas -v`` lines of `source` in the kernel library's build
    log: each function's stack frame and spills, each kernel's registers."""
    part = next((p for p in _build.build_log().split("== ") if p.startswith(source)), "")
    keys = ("Function properties", "stack frame", "Used")
    return [line.strip() for line in part.splitlines() if any(k in line for k in keys)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1024,128,64", help="row counts of the phase split and the timings")
    ap.add_argument("--check", default="1,17,64,128,129,1024", help="row counts checked against the plain version")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pairing_probe: needs a CUDA device")
    dev = torch.device("cuda")
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, S)), tp.prepare_g2(rc.G2_GEN))
    default = cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK
    out: dict = {"phases": {}, "ms": {}}
    path = pairing_program.program_stats()["row"]
    try:
        for B in (int(x) for x in args.check.split(",") if x):
            el, er, want = check_rows(B, B, dev)
            if not torch.equal(cuda_pairing.pairing_check_plain(el, er, pp), want):
                raise SystemExit(f"pairing_probe: the plain check disagrees with the rows at B = {B}")
            for lanes, rows in (default, (32, 3), (16, 3)):
                cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK = lanes, rows
                if not torch.equal(cuda_pairing.pairing_check(el, er, pp), want):
                    raise SystemExit(f"pairing_probe: kernel wrong at B = {B}, {lanes} lanes, {rows} rows per block")
            print(f"B = {B}: kernel == plain == construction ({int(want.sum())} true)", flush=True)
        sizes = [int(x) for x in args.rows.split(",") if x]
        el, er, want = check_rows(max(sizes), 5, dev)
        for n in sizes:
            for lanes, rows in CONFIGS:
                cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK = lanes, rows
                key = f"{lanes}x{rows or 'auto'}"
                ph = torch.zeros((n, 10), dtype=torch.int64, device=dev)
                if not torch.equal(cuda_pairing.pairing_check(el[:n], er[:n], pp, phases=ph), want[:n]):
                    raise SystemExit(f"pairing_probe: kernel wrong at {n} rows, {key}")
                live = ph[:, 5] != 0
                cyc = (ph[live, 1:6] - ph[live, :5]).double().median(0).values.tolist()
                cyc += ph[live, 6:].double().median(0).values.tolist()
                totals = (ph[live, 5] - ph[live, 0]).double()
                total = totals.median().item()
                both = (live & ~tc.is_identity(el[:n]) & ~tc.is_identity(er[:n]))
                spread = {"rows_min": totals.min().item(), "rows_max": totals.max().item(),
                          "both_live_median": (ph[both, 5] - ph[both, 0]).double().median().item(),
                          "one_live_median": (ph[live & ~both, 5] - ph[live & ~both, 0]).double().median().item()
                          if bool((live & ~both).any()) else None}
                ms = device_ms(lambda: cuda_pairing.pairing_check(el[:n], er[:n], pp), ["pairing_kernel"],
                               calls=args.reps)
                crit = path.get(lanes)
                per = ({"per_stage": spread["both_live_median"] / crit["stages"],
                        "per_term": spread["both_live_median"] / crit["terms"], "critical_path": crit}
                       if crit else {})
                out["phases"][f"{n}/{key}"] = dict(zip(PHASES + STAGE_KINDS, cyc), total=total, **per)
                out["ms"][f"{n}/{key}"] = ms
                print(json.dumps({"rows": n, "lanes": lanes, "rows_per_block": rows, "device_ms": ms,
                                  "cycles": dict(zip(PHASES + STAGE_KINDS, cyc), total=total, **spread), **per}),
                      flush=True)
    finally:
        cuda_pairing.LANES, cuda_pairing.ROWS_PER_BLOCK = default
    for line in ptxas_lines("pairing.cu"):
        print("[ptxas]", line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return out


if __name__ == "__main__":
    main()
