"""Profiling harness: the counterpart of
``plutus_halo2_tpu/utils/profiling.py`` (``xla_trace``, ``StageTimer``).

``torch_trace`` records host and CUDA activity with ``torch.profiler`` and
exports a Chrome trace (open it in Perfetto or ``chrome://tracing``);
``device_busy_share`` reads the one number such a trace must yield: the
share of the traced window in which the card ran anything."""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import time

import torch

TRACE_FILE = "trace.json.gz"
# Chrome-trace categories of the card's own activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def torch_trace(out_dir: str):
    """Record CPU (and, with a card, CUDA) activity around a block and
    export it as a gzipped Chrome trace, ``out_dir/trace.json.gz``; yields
    that path. Queued device work is waited for before the profiler stops."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if cuda:
                torch.cuda.synchronize()
    raw = path[: -len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as fin, gzip.open(path, "wb") as fout:
        fout.writelines(fin)
    os.remove(raw)


def _trace_events(trace) -> list:
    if isinstance(trace, (str, os.PathLike)):
        with (gzip.open if str(trace).endswith(".gz") else open)(trace, "rt") as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if e.get("ph") == "X" and "dur" in e]


def device_busy_us(trace) -> tuple[float, float]:
    """(busy, window) in us: the union of the device's intervals (kernels,
    copies, fills) and the traced window (the first event's start to the
    last one's end).

    `trace`: a Chrome-trace file (torch_trace's path, gzipped or not), its
    parsed JSON, or a list of its events (dicts with "ph", "cat", "ts",
    "dur" in us). Raises ValueError when the trace holds no device
    activity: a CPU trace, or a profiler that could not read the card."""
    events = _trace_events(trace)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES)
    if not spans:
        raise ValueError("the trace holds no device activity")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, end - start


def device_busy_share(trace) -> float:
    """The share of the traced window in which the card ran anything
    (device_busy_us's busy over its window)."""
    busy, window = device_busy_us(trace)
    return busy / window


def device_time_by_name(trace, top: int | None = None) -> list[tuple[str, int, float]]:
    """(name, count, total us) of the device's activities, most total time
    first (the first `top` of them when given)."""
    totals: dict[str, list] = {}
    for e in _trace_events(trace):
        if e.get("cat") in DEVICE_CATEGORIES:
            t = totals.setdefault(e.get("name", "?"), [0, 0.0])
            t[0] += 1
            t[1] += float(e["dur"])
    return sorted(((n, c, us) for n, (c, us) in totals.items()), key=lambda r: -r[2])[:top]


def call_ms(fn, device) -> float:
    """One call of fn in ms: CUDA events around it on a CUDA device (the
    card's time, waited for), the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them ("cpu" on the CPU)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


class StageTimer:
    """Coarse wall-clock stage breakdown, emitted as one JSON line, as the
    JAX package's StageTimer. On a CUDA device each stage's edges wait for
    the queued device work, so a stage's time includes its kernels."""

    def __init__(self, device=None):
        self.stages: dict[str, float] = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync:
            torch.cuda.synchronize()
        t0 = time.time()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.stages.items()})
