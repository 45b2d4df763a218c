"""Probe of the lane-group curve kernels (``csrc/msm.cu``,
``csrc/decompress.cu``, ``csrc/subgroup.cu``), of the Fp primitives under
them and of the lane-split product of the pow kernel (``csrc/lanes.cuh``),
on one GPU.

    python3 -m plutus_halo2_tpu_torch.tools.curve_probe [--batch 1024]

Prints one JSON line per measurement:

1. ``primitive``: the cycles of one dependent step of each Fp primitive
   (``csrc/field_test.cu``'s probe: f_mul, f_mul2's two products,
   fp_mul_cc, two fp_mul_cc, f_add, fp_add_cc, f_sub, fp_sub_cc; median
   over the warps) with 1 and with 8 warps on every SM; each PTX
   carry-chain variant's outputs must equal its counterpart's;
2. ``lanes``: the cycles of one dependent product of each field, on one
   thread (``f_mul``) and split over T lanes (a squaring step of the pow
   kernel: ``lanes_gather``, then ``f_mul_lanes``; Fp T = 2, 4, Fr T = 2,
   4, 8), with 1 and with 8 warps on every SM; every split product's
   outputs must equal ``f_mul``'s;
3. ``msm``: at (B, 16) and at the RLC aggregation's (B / 4, 8), both window
   widths, the kernel's phases in SM cycles from its ``clock64()`` marks
   (median row: the tables and window sums, the chain) and the chain's
   cycles per product stage (2 per doubling and per addition), beside the
   lanes a row its launcher fixes;
4. ``decompress``: at (B, 10), 1 and 2 rounds: decoding, the window part
   (tables, window sums, chain) and the z-ladders with the comparison;
5. ``subgroup``: at (B, 10), 1 and 2 rounds: the loads, the window part
   and the z-ladders with the comparison;

each kernel's output checked against its plain version. Last the card's
``nvidia-smi`` name and power limit. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import _build, cuda_curve
from ..ops import curve as tc
from ..ops.limb import FP_SPEC, FR_SPEC
from ..refimpl import curve as rc

VARIANTS = ("f_mul", "f_mul2", "fp_mul_cc", "fp_mul_cc_x2", "f_add", "fp_add_cc", "f_sub", "fp_sub_cc")
PAIRS = ((0, 2), (1, 3), (4, 5), (6, 7))  # (uint64 emulation, PTX carry chains): the same outputs


def primitives(dev, steps: int = 64) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.library()
    for warps in (1, 8):
        n = sms * 32 * warps
        rng = np.random.default_rng(warps)
        vals = [int.from_bytes(rng.bytes(48), "little") % FP_SPEC.N for _ in range(3 * n)]
        x = torch.tensor(np.array([_build.kernel_fp(v) for v in vals], dtype=np.uint32).view(np.int32),
                         device=dev).reshape(n, 36)
        results, cycles = [], {}
        for v, name in enumerate(VARIANTS):
            y = torch.empty((n, 24), dtype=torch.int32, device=dev)
            cyc = torch.empty((n // 32,), dtype=torch.int64, device=dev)
            _build.check(lib.ph2_fp_step_probe(_build.ptr(x), _build.ptr(y), _build.ptr(cyc), sms, warps, steps, v,
                                               _build.stream_ptr()), "ph2_fp_step_probe")
            torch.cuda.synchronize()
            results.append(y)
            cycles[name] = float(cyc.double().median()) / steps
        for a, b in PAIRS:
            if not torch.equal(results[a], results[b]):
                raise SystemExit(f"curve_probe: {VARIANTS[b]} differs from {VARIANTS[a]}")
        print(json.dumps({"probe": "primitive", "warps_per_sm": warps, "steps": steps, "cycles_per_step": cycles}))


LANE_SPLITS = {"fp": (1, 2, 4), "fr": (1, 2, 4, 8)}  # 1: one thread, f_mul


def lane_products(dev, steps: int = 64) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.library()
    for field, (spec, nw) in enumerate(((FP_SPEC, 12), (FR_SPEC, 8))):
        for warps in (1, 8):
            threads = sms * 32 * warps
            rng = np.random.default_rng(warps + 10 * field)
            cycles = {}
            for lanes in LANE_SPLITS[spec.name]:
                n = threads // lanes
                vals = [int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N for _ in range(2 * n)]
                words = [_build.words(v * (1 << (32 * nw)) % spec.N, nw) for v in vals]
                x = torch.tensor(np.array(words, dtype=np.uint32).view(np.int32), device=dev).reshape(n, 2 * nw)
                y = torch.empty((n, nw), dtype=torch.int32, device=dev)
                cyc = torch.empty((threads // 32,), dtype=torch.int64, device=dev)
                _build.check(lib.ph2_lanes_step_probe(_build.ptr(x), _build.ptr(y), _build.ptr(cyc), sms, warps, steps,
                                                      field, lanes, _build.stream_ptr()), "ph2_lanes_step_probe")
                torch.cuda.synchronize()
                if lanes > 1 and not torch.equal(y, _one_thread(lib, x, steps, field, nw, dev)):
                    raise SystemExit(f"curve_probe: {spec.name} product on {lanes} lanes differs from f_mul")
                cycles[lanes] = float(cyc.double().median()) / steps
            print(json.dumps({"probe": "lanes", "field": spec.name, "warps_per_sm": warps, "steps": steps,
                              "cycles_per_product_by_lanes": cycles}))


def _one_thread(lib, x, steps, field, nw, dev):
    """f_mul's outputs on x's elements (one thread an element)."""
    n = x.shape[0]
    threads = -(-n // 32) * 32
    pad = torch.zeros((threads - n, 2 * nw), dtype=torch.int32, device=dev)
    xp = torch.cat([x, pad]).contiguous()
    y = torch.empty((threads, nw), dtype=torch.int32, device=dev)
    cyc = torch.empty((threads // 32,), dtype=torch.int64, device=dev)
    _build.check(lib.ph2_lanes_step_probe(_build.ptr(xp), _build.ptr(y), _build.ptr(cyc), threads // 32, 1, steps,
                                          field, 1, _build.stream_ptr()), "ph2_lanes_step_probe")
    torch.cuda.synchronize()
    return y[:n]


def _median_row(phases) -> list[float]:
    p = phases.double()
    return [float(x) for x in (p[:, 1:] - p[:, :-1]).median(0).values]


def msm_phases(dev, B: int, rng) -> None:
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=16)] + [None]
    tab = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in host])).to(dev)
    for rows, K in ((B, 16), (B // 4, 8)):
        pts = tab[torch.from_numpy(rng.integers(0, len(host), size=(rows, K))).to(dev)].contiguous()
        vals = [int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(rows * K)]
        sc = torch.from_numpy(np.stack([FR_SPEC.encode(v) for v in vals]).reshape(rows, K, FR_SPEC.L)).to(dev)
        for wbits in (5, 4):
            ph = torch.zeros((rows, 3), dtype=torch.int64, device=dev)
            got = cuda_curve.msm(pts, sc, wbits=wbits, phases=ph)
            if not torch.equal(got, tc.msm_windowed(pts, sc, wbits)):
                raise SystemExit(f"curve_probe: msm at ({rows}, {K}), wbits {wbits} differs from its plain version")
            window, chain = _median_row(ph)
            nwin = tc.MSM_NWIN[wbits]
            stages = 2 * (nwin - 1) * (wbits + 1)
            print(json.dumps({"probe": "msm", "rows": rows, "K": K, "wbits": wbits,
                              "lanes": _build.launch_constant("msm.cu", "MSM_LANES"),
                              "cycles": {"tables_and_window_sums": window, "chain": chain},
                              "chain_stages": stages, "cycles_per_chain_stage": chain / stages}))


def decompress_phases(dev, B: int, rng) -> None:
    pool = [rc.g1_mul(rc.G1_GEN, int(k)) for k in rng.integers(1, 2**62, size=16)]
    pick = rng.integers(0, len(pool), size=(B, 10))
    raw = torch.from_numpy(np.stack([np.frombuffer(rc.g1_compress(p), np.uint8) for p in pool])[pick]).to(dev)
    hints = torch.from_numpy(np.stack([FP_SPEC.encode(p[1]) for p in pool])[pick]).to(dev)
    for rounds in (1, 2):
        w = tc.subgroup_weights(10, rounds, torch.Generator().manual_seed(rounds))
        ph = torch.zeros((B, 4), dtype=torch.int64, device=dev)
        got = cuda_curve.decompress_hinted(raw, hints, w, phases=ph)
        want = cuda_curve.decompress_hinted_plain(raw, hints, w)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"curve_probe: decompress at {rounds} rounds differs from its plain version")
        decode, window, ladders = _median_row(ph)
        # the window chain: 5 windows of 3 doublings and an addition; the
        # ladders: 2 x (63 doublings, 5 additions), an addition, 2 compare stages
        print(json.dumps({"probe": "decompress", "rows": B, "K": 10, "rounds": rounds,
                          "lanes": _build.launch_constant("decompress.cu", "DECOMPRESS_LANES"),
                          "cycles": {"decode": decode, "tables_window_sums_chain": window,
                                     "ladders_and_compare": ladders},
                          "cycles_per_ladder_stage": ladders / (2 * (2 * 68 + 1) + 2)}))


def subgroup_phases(dev, B: int, rng) -> None:
    pool = [rc.g1_mul(rc.G1_GEN, int(k)) for k in rng.integers(1, 2**62, size=16)]
    tab = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in pool])).to(dev)
    pts = tab[torch.from_numpy(rng.integers(0, len(pool), size=(B, 10))).to(dev)].contiguous()
    for rounds in (1, 2):
        w = tc.subgroup_weights(10, rounds, torch.Generator().manual_seed(rounds))
        ph = torch.zeros((B, 4), dtype=torch.int64, device=dev)
        got = cuda_curve.aggregate_subgroup_check(pts, w, phases=ph)
        if not torch.equal(got, tc.aggregate_subgroup_check_windowed(pts, w)) or not bool(got.all()):
            raise SystemExit(f"curve_probe: subgroup at {rounds} rounds differs from its plain version")
        load, window, ladders = _median_row(ph)
        print(json.dumps({"probe": "subgroup", "rows": B, "K": 10, "rounds": rounds,
                          "lanes": _build.launch_constant("subgroup.cu", "SUBGROUP_LANES"),
                          "cycles": {"load": load, "tables_window_sums_chain": window,
                                     "ladders_and_compare": ladders},
                          "cycles_per_ladder_stage": ladders / (2 * (2 * 68 + 1) + 2)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("curve_probe: needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    primitives(dev)
    lane_products(dev)
    msm_phases(dev, args.batch, rng)
    decompress_phases(dev, args.batch, rng)
    subgroup_phases(dev, args.batch, rng)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
