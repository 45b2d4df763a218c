"""Probe of the kernel timer's profiler windows on one GPU.

    python3 -m plutus_halo2_tpu_torch.tools.timer_probe [--seconds 120] [--every 10]

``utils.profiling.device_ms`` reads kernel durations from ``torch.profiler``
windows. This probe asks when such a window loses device records. Every
`--every` seconds for `--seconds` it records windows (CPU and CUDA
activity) of a start marker (``torch.cuda._sleep``, short), 5 calls of a
small elementwise kernel (20,000 in the burst window) and an end marker
(long): "plain" with 3 ms of idle host at each end, "primed N" with N
filler kernels before the start marker and 16 after the end marker
instead. Per window it prints the process's age, the kernels the window
holds of those launched, whether each marker is there, and the skew: the
median, over the window's kernels, of a kernel's start minus its launch's
start on the host (both on the profiler's clock; a few us when the clocks
agree). Then ``device_ms`` of the same 5 calls and the fillers it needed.
Last the card's ``nvidia-smi`` name and power limit. Needs a CUDA
device."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from ..utils.profiling import MARK, MARK_CYCLES, WINDOW, card_line, device_ms

BURST = 20_000
END_CYCLES = 50 * MARK_CYCLES  # the end marker spins ~25 us, the start marker ~0.5 us
LONG_US = 5.0
VARIANTS = (("plain", 5, 0), ("primed 16", 5, 16), ("primed 1024", 5, 1024), ("burst", BURST, 0))


def _window(calls: int, primers: int, x, y) -> dict:
    """One profiler window of `calls` launches of x.mul_ between the two
    markers; with `primers`, that many y.add_ before and 16 after, else 3
    ms of idle host at each end."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0 if primers else 0.003)
        for _ in range(primers):
            y.add_(1.0)
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(calls):
            x.mul_(1.0)
        torch.cuda._sleep(END_CYCLES)
        for _ in range(16 if primers else 0):
            y.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0 if primers else 0.003)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    marks = sorted(float(e["dur"]) for e in kernels if MARK in e["name"])
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    skews = [float(e["ts"]) - launch[e["args"]["correlation"]] for e in kernels
             if e.get("args", {}).get("correlation") in launch]
    return {"seen": len(kernels), "of": calls + 2 + primers + (16 if primers else 0),
            "start": any(d < LONG_US for d in marks), "end": any(d >= LONG_US for d in marks),
            "skew_ms": statistics.median(skews) / 1e3 if skews else None}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--every", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("timer_probe: needs a CUDA device")
    x, y = torch.ones(1 << 16, device="cuda"), torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    rows = []
    while True:
        age = time.perf_counter() - t0
        for name, calls, primers in VARIANTS:
            rows.append({"age_s": round(age, 1), "window": name, **_window(calls, primers, x, y)})
            print(json.dumps(rows[-1]), flush=True)
        rows.append({"age_s": round(age, 1), "device_ms": device_ms(lambda: x.mul_(1.0), ["elementwise"], 5),
                     "fillers": WINDOW["fillers"]})
        print(json.dumps(rows[-1]), flush=True)
        if age >= args.seconds:
            break
        time.sleep(max(0.0, args.every - (time.perf_counter() - t0 - age)))
    print(card_line("cuda"))
    return rows


if __name__ == "__main__":
    main()
