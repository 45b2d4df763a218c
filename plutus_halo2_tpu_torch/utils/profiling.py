"""Profiling harness: the counterpart of
``plutus_halo2_tpu/utils/profiling.py`` (``xla_trace``, ``StageTimer``).

``torch_trace`` records host and CUDA activity with ``torch.profiler`` and
exports a Chrome trace (open it in Perfetto or ``chrome://tracing``);
``device_busy_share`` reads the one number such a trace must yield: the
share of the traced window in which the card ran anything. ``device_ms``
is the kernel timer of chip_smoke.py, block_sweep.py and the probes: the
device time of a call's own kernels, read from a profiler window."""

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
# On the H100 the profiler lost the first device records of a window, more
# of them the longer a process ran (tools/timer_probe.py: none for 24 s,
# then one more about every 30 s; the clocks agreed to a few us, and idle
# margins did not help). So device_ms runs its calls between two marker
# kernels (torch.cuda._sleep's spin_kernel), counts only what lies between
# them, and opens the window with filler kernels, more of them (for this
# call and the later ones) until the start marker is in the window.
MARK = "spin_kernel"
MARK_CYCLES = 1000
WINDOW = {"fillers": 16, "raised": 0}
MAX_FILLERS = 1 << 16


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


def kernel_us(trace, names=None) -> tuple[float, int]:
    """(total us, count) of the trace's device kernels whose name contains
    one of `names` (every device kernel when None). Raises ValueError when
    no such kernel ran: a CPU trace, a profiler that could not read the
    card, or a window in which the named kernels took no device time."""
    total, count = 0.0, 0
    for e in _trace_events(trace):
        if e.get("cat") == "kernel" and (names is None or any(n in e.get("name", "") for n in names)):
            total += float(e["dur"])
            count += 1
    if not count or total <= 0:
        raise ValueError(f"no device time of kernels {names or 'of any name'} in the trace")
    return total, count


def window_us(events, names, calls: int) -> float | None:
    """The summed device us of the kernels named like `names` (every kernel
    when None) that lie between the two MARK kernels of one window of
    `calls` calls (events: as kernel_us takes them, "ts" and "dur" in us); None
    when the profiler lost records of the window: a marker missing, or
    named kernels that are not a whole number per call. Raises ValueError
    (kernel_us) when the markers are there and the named kernels took no
    device time."""
    kernels = [e for e in _trace_events(events) if e.get("cat") == "kernel"]
    marks = sorted((e for e in kernels if MARK in e.get("name", "")), key=lambda e: float(e["ts"]))
    if len(marks) != 2:
        return None
    lo, hi = float(marks[0]["ts"]) + float(marks[0]["dur"]), float(marks[1]["ts"])
    inside = [e for e in kernels if MARK not in e.get("name", "")
              and lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi]
    total, count = kernel_us(inside, names)
    if names is not None and count % calls:
        return None
    return total


def device_ms(fn, names=None, calls: int = 10, warmup: int = 1) -> float:
    """The device time of one call of fn in ms: the summed durations of
    the device kernels it launches (those whose name contains one of
    `names`, or all of them when None) over a ``torch.profiler`` window of
    `calls` calls, divided by `calls`. The host's path to each launch is not
    in it. The calls run between two marker kernels, after filler kernels
    (see WINDOW) whose number grows until the window holds both markers.
    Raises on the CPU, when the window holds no such kernel, and when a
    marker is lost after MAX_FILLERS fillers: it never falls back to the
    host clock."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    filler = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    while True:
        fillers = WINDOW["fillers"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(fillers):
                filler.add_(1.0)
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        events = [{"ph": "X", "cat": "kernel", "name": e.name, "ts": e.time_range.start,
                   "dur": e.time_range.elapsed_us()} for e in prof.events() if _on_device(e)]
        total = window_us(events, names, calls)
        if total is not None:
            return total / 1e3 / calls
        if fillers >= MAX_FILLERS:
            raise ValueError(f"the profiler lost a marker of the window after {fillers} filler kernels")
        WINDOW["fillers"] = min(4 * fillers, MAX_FILLERS)
        WINDOW["raised"] += 1


def _on_device(evt) -> bool:
    """A profiler event that ran on the card (a kernel, not a copy or fill)."""
    from torch.autograd import DeviceType

    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return False
    name = evt.name.lower()
    return not name.startswith(("memcpy", "memset"))


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
