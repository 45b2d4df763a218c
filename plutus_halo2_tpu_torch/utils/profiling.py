"""Profiling harness: the counterpart of
``plutus_halo2_tpu/utils/profiling.py`` (``xla_trace``, ``StageTimer``).

``torch_trace`` records host and CUDA activity with ``torch.profiler`` and
exports a Chrome trace (open it in Perfetto or ``chrome://tracing``);
``device_busy_share`` reads the one number such a trace must yield: the
share of the traced window in which the card ran anything. ``device_ms``
is the kernel timer of chip_smoke.py and the probes: the
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
# margins did not help), a window of ~105,000 kernels lost its last ~60
# records, and windows that kept every record could still hold wrong
# durations (one of 10 MSM kernels read 23 % short, one of pairing kernels
# 0.6 % longer than the CUDA events around it).
# So device_ms opens each window with filler kernels, runs between marker
# kernels (torch.cuda._sleep's spin_kernel) one call that gives the
# per-call count of the counted kernels and then the timed calls, and
# closes it with as many fillers again. It counts only what lies between
# the markers and takes the window only whole: every marker there, exactly
# calls x that count, no more device time than the CUDA events around the
# calls saw (to their clocks' agreement) and no less than they saw once the
# host had enqueued the calls (less a launch gap a kernel: the queue was
# full, the card busy). A window that lost records is run again with more
# fillers (for this call and the later ones), one with wrong durations
# again as it was, at most DURATION_RETRIES times. Each refused window is
# logged in WINDOW["refused"], the last accepted one's totals in
# WINDOW["last"]. One profiler session a window: with two (one to learn the
# count, one to time), late in a long run every window of one stage lost
# its end marker.
MARK = "spin_kernel"
MARK_CYCLES = 1000
WINDOW = {"fillers": 16, "raised": 0, "refused": []}
MAX_FILLERS = 1 << 16
DURATION_RETRIES = 8
# how far the kernels' durations may exceed the CUDA events around them:
# the events' resolution (~0.5 us), a profiler record's (~1 us a kernel)
# and a relative 5e-4 for the two clocks (accepted windows on an H100 were
# within 1.5e-4)
EVENT_RESOLUTION_MS = 1e-3
RECORD_RESOLUTION_MS = 1e-3
CLOCK_AGREEMENT = 5e-4
# the card's idle time between two queued kernels in a profiled window: 17
# us between 3.3 ms MSM kernels on an H100; the allowance keeps a
# margin and still catches records short by a share of a kernel
LAUNCH_GAP_MS = 0.05


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


def _named(trace, names) -> tuple[float, int]:
    """(total us, count) of the device kernels named like `names` (every
    one when None), (0.0, 0) when there are none."""
    total, count = 0.0, 0
    for e in _trace_events(trace):
        if e.get("cat") == "kernel" and (names is None or any(n in e.get("name", "") for n in names)):
            total += float(e["dur"])
            count += 1
    return total, count


def kernel_us(trace, names=None) -> tuple[float, int]:
    """(total us, count) of the trace's device kernels whose name contains
    one of `names` (every device kernel when None). Raises ValueError when
    no such kernel ran: a CPU trace, a profiler that could not read the
    card, or a window in which the named kernels took no device time."""
    total, count = _named(trace, names)
    if not count or total <= 0:
        raise ValueError(f"no device time of kernels {names or 'of any name'} in the trace")
    return total, count


def _window_gaps(events, marks: int = 2):
    """The kernels strictly between each two consecutive MARK kernels of a
    window of `marks` markers (a list per gap), or None when the window
    holds another number of markers."""
    kernels = [e for e in _trace_events(events) if e.get("cat") == "kernel"]
    found = sorted((e for e in kernels if MARK in e.get("name", "")), key=lambda e: float(e["ts"]))
    if len(found) != marks:
        return None
    edges = [(float(a["ts"]) + float(a["dur"]), float(b["ts"])) for a, b in zip(found, found[1:])]
    return [[e for e in kernels if MARK not in e.get("name", "")
             and lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi] for lo, hi in edges]


def window_us(events, names, calls: int, learn: bool = False) -> float | None:
    """The summed device us of the kernels named like `names` (every kernel
    when None) that lie between the last two MARK kernels of one window of
    `calls` calls (events: as kernel_us takes them, "ts" and "dur" in us).
    With `learn` the window has three markers and one call between the
    first two, whose count of those kernels is the per-call count. None
    when the profiler lost records of the window: a marker missing, or with
    `learn` a count other than calls x the per-call count, else, for named
    kernels, not a whole number per call. Raises ValueError (kernel_us)
    when the markers are there and the named kernels took no device time."""
    gaps = _window_gaps(events, 3 if learn else 2)
    if gaps is None:
        return None
    total, count = kernel_us(gaps[-1], names)
    if learn:
        return total if count == calls * _named(gaps[0], names)[1] else None
    if names is not None and count % calls:
        return None
    return total


def _profiled_window(fn, calls: int, fillers: int, learn: bool):
    """One profiler session: `fillers` filler kernels, a marker, with
    `learn` one call of fn and another marker, then `calls` calls of fn
    between two CUDA events, the end marker and `fillers` more fillers (so
    that a session that drops its last records drops those).
    Returns (the window's
    device kernels as trace events, the events' ms, the host's ms to
    enqueue the calls)."""
    from torch.profiler import ProfilerActivity, profile

    filler = torch.zeros(1, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(fillers):
            filler.add_(1.0)
        torch.cuda._sleep(MARK_CYCLES)
        if learn:
            fn()
            torch.cuda._sleep(MARK_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(fillers):
            filler.add_(1.0)
        torch.cuda.synchronize()
    events = [{"ph": "X", "cat": "kernel", "name": e.name, "ts": e.time_range.start,
               "dur": e.time_range.elapsed_us()} for e in prof.events() if _on_device(e)]
    return events, start.elapsed_time(end), host_ms


def _refuse(reason: str, names, fillers: int, lost: bool = True):
    """Log a refused window; after a window that lost records, more fillers."""
    WINDOW["refused"].append({"names": names, "reason": reason, "fillers": fillers})
    if not lost:
        return
    if fillers >= MAX_FILLERS:
        raise ValueError(f"device_ms: the profiler lost records of the window after {fillers} filler "
                         f"kernels ({reason})")
    WINDOW["fillers"] = min(4 * fillers, MAX_FILLERS)
    WINDOW["raised"] += 1


def device_ms(fn, names=None, calls: int = 10, warmup: int = 1, exact_count: bool = True) -> float:
    """The device time of one call of fn in ms: the summed durations of
    the device kernels it launches (those whose name contains one of
    `names`, or all of them when None) over a ``torch.profiler`` window of
    `calls` calls, divided by `calls`. The host's path to each launch is not
    in it. The calls run between two marker kernels, after filler kernels
    (see WINDOW) whose number grows until the window is whole: both markers
    there; with `exact_count`, exactly `calls` x the per-call count of those
    kernels that one more call before them, between markers of the same
    window, showed (for functions of a few kernels: a whole batch's ~20,000
    small kernels are counted only for their device time); a total no
    larger than the CUDA-event time of the calls (to the clocks'
    agreement); and all the window's kernels together no shorter than that
    time less the host's time to enqueue the calls and LAUNCH_GAP_MS a
    kernel (after the last launch the queued kernels run back to back).
    Raises on the CPU, when the window holds no such kernel, when a window
    lost records at MAX_FILLERS fillers, and after DURATION_RETRIES windows
    with wrong durations: it never falls back to the host clock."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    marks = 3 if exact_count else 2
    wrong = 0  # windows refused for their durations
    while True:
        fillers = WINDOW["fillers"]
        events, event_ms, host_ms = _profiled_window(fn, calls, fillers, learn=exact_count)
        total = window_us(events, names, calls, learn=exact_count)
        # once the host has enqueued every call, the card runs them without a
        # pause: its kernels then fill the events' time but for the
        # enqueueing and a launch gap a kernel
        gaps = _window_gaps(events, marks)
        busy_ms, n_all = _named(gaps[-1], None) if gaps else (0.0, 0)
        floor_ms = event_ms - host_ms - LAUNCH_GAP_MS * n_all
        if total is None:
            if gaps is None:
                order = sorted(events, key=lambda e: float(e["ts"]))
                seen = [i for i, e in enumerate(order) if MARK in e["name"]]
                reason = (f"{len(seen)} of {marks} markers among {len(events)} kernels (at {seen[:4]}; launched "
                          f"{fillers} fillers, the calls, {fillers} fillers)")
            else:
                counts = [_named(g, names)[1] for g in gaps]
                reason = (f"{counts[-1]} kernels where {calls} calls launch "
                          + (f"{calls} x {counts[0]}" if exact_count else f"a multiple of {calls}"))
            _refuse(reason, names, fillers)
        elif (total / 1e3 > event_ms * (1 + CLOCK_AGREEMENT) + EVENT_RESOLUTION_MS + RECORD_RESOLUTION_MS * n_all
              or busy_ms / 1e3 < floor_ms):
            wrong += 1
            _refuse(f"{total / 1e3:.4f} ms of the counted kernels, {busy_ms / 1e3:.4f} of all, in {event_ms:.4f} "
                    f"ms of CUDA events, {host_ms:.4f} ms of them enqueueing", names, fillers, lost=False)
            if wrong >= DURATION_RETRIES:
                raise ValueError(f"device_ms: {wrong} windows with wrong durations in a row at {fillers} fillers")
        else:
            WINDOW["last"] = {"names": names, "calls": calls, "fillers": fillers, "device_ms": total / 1e3,
                              "event_ms": event_ms, "host_ms": host_ms, "busy_ms": busy_ms / 1e3}
            return total / 1e3 / calls


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
