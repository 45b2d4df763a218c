"""The traced sub-window of a ``--trace 1`` run and what is read from it.

A whole window is too many device records to trace (~20,300 a batch in the
graph form), so a run traces ``trace_batches`` whole batches with
``torch.profiler`` (CPU and CUDA activity), between two marker kernels
(``torch.cuda._sleep``'s ``spin_kernel``) after filler kernels, as the
port's ``utils/profiling.device_ms`` does: on the H100 the profiler lost
the first device records of a window, more the longer a process ran, and
the last ones of a window of ~105,000 kernels. Only what lies between the
markers is read, and only whole: both markers there and the same number of
kernels for every batch; a sub-window that fails this is traced again,
after the window, with four times the fillers, at most ``ATTEMPTS`` times.
``record_function`` spans of the harness (``HOST_SPANS``) name what the
host was doing; their mirrors on the device's timeline are not device
activity.

The arithmetic of ``device_busy_us`` (the union of the device's
intervals) and ``device_time_by_name`` is copied from the port's
``utils/profiling.py``."""

from __future__ import annotations

from dataclasses import dataclass, field

MARK = "spin_kernel"
MARK_CYCLES = 1000
FILLERS = 64
ATTEMPTS = 3
NAME_CHARS = 96  # a breakdown entry's name, cut to this length
HOST_SPANS = ("portbench.issue", "portbench.finish")


@dataclass
class Trace:
    """What lay between the markers: device activities and kernels as
    (name, start us, duration us), the harness's host spans likewise, the
    window's bounds (us) and the batches traced."""

    device: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    host: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    batches: int = 0
    layouts: list = field(default_factory=list)
    attempts: int = 1

    @property
    def window_us(self) -> float:
        return self.end - self.start


def busy_us(intervals) -> float:
    """The union's length of (start, duration) intervals, in us."""
    spans = sorted((s, s + d) for _n, s, d in intervals)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """(start, end) us of every stretch of the window in which the device
    ran nothing."""
    spans = sorted((s, s + d) for _n, s, d in trace.device)
    gaps, cur = [], trace.start
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if trace.end > cur:
        gaps.append((cur, trace.end))
    return gaps


def by_name(intervals) -> list[tuple[str, int, float]]:
    """(name, count, total us), most total time first."""
    totals: dict[str, list] = {}
    for name, _s, d in intervals:
        t = totals.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += d
    return sorted(((n, c, us) for n, (c, us) in totals.items()), key=lambda r: -r[2])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each named by the harness's host span it fell in."""
    ops = [[n[:NAME_CHARS], us / 1e6] for n, _c, us in by_name(trace.device)[:top]]
    gaps = []
    for s, e in sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        inside = [n for n, hs, hd in trace.host if hs <= mid <= hs + hd]
        gaps.append([inside[-1] if inside else "host: between calls", (e - s) / 1e6])
    return {"device_ops": ops, "idle_gaps": gaps}


def read(shot) -> Trace | None:
    """The sub-window between the markers of a recorded shot, or None when
    it is not whole."""
    from torch.autograd import DeviceType

    prof, layouts, attempt = shot
    n_batches = len(layouts)
    device, host = [], []
    for e in prof.events():
        start, dur = float(e.time_range.start), float(e.time_range.elapsed_us())
        if e.name in HOST_SPANS:  # the span on the host, and its mirror on the device's timeline
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                host.append((e.name, start, dur))
        elif getattr(e, "device_type", None) == DeviceType.CUDA:
            device.append((e.name, start, dur))
    marks = sorted((s, d) for n, s, d in device if MARK in n)
    if len(marks) != 2:
        return None
    lo, hi = marks[0][0] + marks[0][1], marks[1][0]
    inside = [(n, s, d) for n, s, d in device if MARK not in n and lo <= s and s + d <= hi]
    kernels = [x for x in inside if not x[0].lower().startswith(("memcpy", "memset"))]
    if not kernels or len(kernels) % n_batches:
        return None
    return Trace(inside, kernels, [h for h in host if lo <= h[1] <= hi], lo, hi, n_batches, layouts, attempt)


def record(run_batches, n_batches: int, attempt: int = 1):
    """run_batches(n) issues and finishes n whole batches (returning their
    layout indices); they run under the profiler between the markers, after
    FILLERS x 4^(attempt - 1) fillers. Returns the shot that ``read``
    reads (reading it takes seconds, so a run reads it after its window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    filler = torch.zeros(1, device="cuda")
    fillers = FILLERS * 4 ** (attempt - 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(fillers):
            filler.add_(1.0)
        torch.cuda._sleep(MARK_CYCLES)
        layouts = run_batches(n_batches)
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(fillers):
            filler.add_(1.0)
        torch.cuda.synchronize()
    return prof, layouts, attempt
