"""Tracing: the port's calls from inside, and verification values.

**The recorder** (``RECORDER``; ``enable()`` / ``disable()``, off by
default). While on, each call of ``TorchVerifier.verify()`` and
``verify_rlc_device()`` leaves one ``Call`` in a ring of ``CAPACITY``
records (the oldest overwritten, and counted, once the ring is full):

- host spans on ``time.perf_counter``, each with its name, start, end and
  parent: ``ph2.call`` (the entry call, to its return) and its children
  ``ph2.load`` (staging the inputs, ``models/programs.py``'s ``_load``:
  the one place the issue path can block on the card) and ``ph2.launch``
  (the graph's replay alone). While a ``torch.profiler`` is active each span
  also opens a record function of its name, so the profiler's trace
  carries them beside the kernels, on its own clock. It is a
  function-scope one (``_RecordFunctionFast``), listed among the host's
  ops: ``record_function``'s user scope would also draw a mirror of each
  span over its kernels on the device's timeline, which a reader of the
  trace would take for device work;
- two CUDA events recorded on the current stream: ``call_start`` (before
  the inputs' copies) and ``call_end`` (after the outputs' clones);
- the body's stage marks (``TorchVerifier._stage``): inside a graph
  captured while tracing was on, each stage boundary is an event-record
  node, which every traced replay re-points to the call's own events (so
  two calls in flight never share one; ``models/programs.py``); an eager
  body records the same boundaries as CUDA events on the card and
  ``perf_counter`` reads on the CPU. The first mark is the body's start
  (``graph_start``), the last its end (``graph_end``). The top-level
  stages tile the body: each starts where the one before it ends, the
  first at the first mark, the last ends at the last; a child stage
  (``fr_pow``, ``msm``, GWC19's ``msm_w``) has its own pair.

The events are a preallocated ring of event sets, one a ring slot; nothing
waits for them on the hot path. ``calls()`` synchronises once, maps every
event onto ``perf_counter`` (``_Clock``: reference events recorded with the
host synchronised, at the first traced capture and at each ``calls()``, a
linear drift fitted between the first and the last) and returns the
records. Off, an entry call costs one attribute check, and a graph captured
with tracing off has no event nodes: tracing at capture is part of the
program's key.

**Verification values** — the analog of the reference's `plutus_debug`
traces, the port's copy of ``plutus_halo2_tpu/utils/tracing.py``. The
reference's Plinth emitter can fill a {{TRACES}} slot with labeled values
of every challenge, gate evaluation, and query (code_emitters_plinth.rs:680-776,
BlsUtils.hs:66-117). Here the refimpl verifier exposes the same intermediates
via `verify(..., collect_traces=True)`, and this module renders them and
diffs two trace sets — the bit-exactness debugging tool for spec-vs-device
work: in the port, the spec's ``el`` / ``er`` against ``TorchVerifier.core``'s
``el`` and ``-er`` in affine coordinates (``device_traces``)."""

from __future__ import annotations

import ctypes
import itertools
import threading
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from ..ops import _build

CAPACITY = 4096  # calls the ring keeps
DEVICE_EVENTS = ("call_start", "call_end")  # recorded eagerly; graph_start and graph_end are stage marks
CALL_START, CALL_END = range(2)
MARKS = len(DEVICE_EVENTS)  # a call's stage marks follow its device events in its event set
CLOCK_TRIES = 8  # reference events a calibration brackets; the tightest is kept

_LOCAL = threading.local()  # the stages of the body this thread runs, while traced


class Span:
    __slots__ = ("name", "start", "end", "parent")

    def __init__(self, name, start, parent):
        self.name, self.start, self.end, self.parent = name, start, None, parent

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


class Stage:
    """One stage of a call's body: host-clock start and end (s), the device
    ms between its marks, and its parent's index in ``Call.stages``."""

    __slots__ = ("name", "parent", "start", "end", "ms")

    def __init__(self, name, parent, start, end, ms):
        self.name, self.parent, self.start, self.end, self.ms = name, parent, start, end, ms


class _SpanScope:
    __slots__ = ("call", "name", "index", "mirror")

    def __init__(self, call, name):
        self.call, self.name = call, name

    def __enter__(self):
        c = self.call
        self.mirror = None
        if _profiler._is_profiler_enabled:
            self.mirror = _RecordFunctionFast(self.name)
            self.mirror.__enter__()
        self.index = len(c.spans)
        c.spans.append(Span(self.name, time.perf_counter(), c._open[-1] if c._open else None))
        c._open.append(self.index)

    def __exit__(self, *exc):
        c = self.call
        c.spans[self.index].end = time.perf_counter()
        c._open.pop()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)


class Stages:
    """The stage marks of one run of a body. ``mark(i)`` records boundary i;
    ``plan`` lists each stage as [name, parent index or None, start mark,
    end mark]. A top-level stage starts at the mark that ends the one
    before it (the first at mark 0, the body's start); ``end()`` records the
    last mark, which ends the last one."""

    def __init__(self, mark):
        self.mark = mark
        self.plan: list = []
        self.count = 0
        self._open: list = []  # indices of the open stages, innermost last
        self._top = None  # the last top-level stage

    def _new(self) -> int:
        i = self.count
        self.mark(i)
        self.count += 1
        return i

    def begin(self):
        self._new()

    def stage(self, name, fn):
        if self._open:
            parent, start = self._open[-1], self._new()
        else:
            parent, start = None, 0 if self._top is None else self._new()
            if self._top is not None:
                self.plan[self._top][3] = start
        i = len(self.plan)
        self.plan.append([name, parent, start, None])
        if parent is None:
            self._top = i
        self._open.append(i)
        try:
            out = fn()
        finally:
            self._open.pop()
        if parent is not None:
            self.plan[i][3] = self._new()
        return out

    def end(self):
        last = self._new()
        if self._top is not None:
            self.plan[self._top][3] = last

    def run(self, body, *args):
        """body(*args) with this thread's stages marked here."""
        prev = getattr(_LOCAL, "stages", None)
        _LOCAL.stages = self
        try:
            self.begin()
            out = body(*args)
            self.end()
        finally:
            _LOCAL.stages = prev
        return out


def active_stages() -> Stages | None:
    """The stages of the traced body this thread is running, if any."""
    return getattr(_LOCAL, "stages", None)


class CaptureStages(Stages):
    """Stages marked inside a CUDA graph capture: each mark an event-record
    node (a CUDA event recorded as external), found again in the captured
    graph by its event (``models/programs.py``)."""

    def __init__(self):
        super().__init__(self._record)
        self.events: list = []

    def _record(self, _i):
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.events.append(ev)


class _EventSet:
    """A ring slot's CUDA events on one card, reused by the slot's every
    call; each recorded once when made, so that its CUDA event handle
    exists and a graph's node can be pointed at it."""

    def __init__(self, card: int):
        self.card = card
        self.events: list = []
        self.handles = None  # the events' handles, a ctypes array

    def record(self, k: int):
        """Event k on the card's current stream: one C call (torch's
        ``Event.record`` builds a Stream object and a device guard around
        the same ``cudaEventRecord``)."""
        _build.check(_build.library().ph2_event_record(
            self.handles[k], torch._C._cuda_getCurrentRawStream(self.card)), "ph2_event_record")

    def reserve(self, n: int):
        if len(self.events) >= n:
            return
        with torch.cuda.device(self.card):
            new = [torch.cuda.Event(enable_timing=True) for _ in range(n - len(self.events))]
            for e in new:
                e.record()
        self.events += new
        self.handles = (ctypes.c_void_p * n)(*[e.cuda_event for e in self.events])

    def marks(self, n: int) -> int:
        """The address of the handles of stage marks 0 to n - 1."""
        self.reserve(MARKS + n)
        return ctypes.addressof(self.handles) + MARKS * ctypes.sizeof(ctypes.c_void_p)


class _Clock:
    """A card's event clock on the host's ``perf_counter``. A reference is a
    CUDA event recorded with the host synchronised, between two host reads;
    of ``CLOCK_TRIES`` it keeps the tightest bracket, placed at its middle
    with half its width as the uncertainty. An event maps to the first
    reference's host time plus its device time since, scaled by the drift
    fitted between the first reference and the last."""

    def __init__(self, device: torch.device):
        self.device = device
        self.refs: list = []  # (event, host s, half bracket s)

    def calibrate(self):
        best = None
        with torch.cuda.device(self.device):
            for _ in range(CLOCK_TRIES):
                torch.cuda.synchronize()
                ev = torch.cuda.Event(enable_timing=True)
                a = time.perf_counter()
                ev.record()
                ev.synchronize()
                b = time.perf_counter()
                if best is None or (b - a) / 2 < best[2]:
                    best = (ev, (a + b) / 2, (b - a) / 2)
        self.refs.append(best)

    @property
    def scale(self) -> float:
        """Host seconds per device second (1 + the drift)."""
        if len(self.refs) < 2:
            return 1.0
        (e1, t1, _u1), (e2, t2, _u2) = self.refs[0], self.refs[-1]
        dev_s = e1.elapsed_time(e2) / 1e3
        return (t2 - t1) / dev_s if dev_s > 0 else 1.0

    @property
    def uncertainty(self) -> float:
        return max(u for _e, _t, u in self.refs)

    def to_host(self, ev, scale: float) -> float:
        e1, t1, _u = self.refs[0]
        return t1 + e1.elapsed_time(ev) / 1e3 * scale


class Call:
    """One traced entry call. While it runs: its spans and the device events
    or, on the CPU, clock reads it recorded. After ``Recorder.calls()``:
    ``device`` (each of DEVICE_EVENTS, and ``graph_start`` and ``graph_end``
    (the first and last stage marks), on the host clock, s), ``graph_ms``
    (graph_end - graph_start, device ms) and ``stages``. ``captured``: the
    call captured its key's program (and has no device times); ``nodes``:
    the census of the program it ran (``models/programs.py``);
    ``msm_terms``: the de-duplicated K of each MSM call of its body, as
    counted when the program was captured (an eager call: as it ran)."""

    def __init__(self, cid: int, entry: str, card: int | None, events: _EventSet | None):
        self.id, self.entry, self.card = cid, entry, card  # card: the CUDA device's index; None on the CPU
        self.spans: list[Span] = []
        self._open: list = []
        self.captured = False
        self.nodes = None
        self.msm_terms = None
        self.plan = None
        self._events = events  # the slot's event set on the card; None on the CPU
        self._times: dict = {}  # the CPU's clock reads, by mark
        self._timed = False
        self.device = None
        self.graph_ms = None
        self.stages: list[Stage] = []

    def span(self, name: str) -> _SpanScope:
        return _SpanScope(self, name)

    def span_named(self, name: str) -> Span | None:
        return next((s for s in self.spans if s.name == name), None)

    def event(self, k: int):
        """Record device event k (DEVICE_EVENTS) on the current stream."""
        self._timed = True
        if self._events is None:
            self._times[k] = time.perf_counter()
        else:
            self._events.record(k)

    def marks(self, n: int) -> int:
        """The handles of this call's stage marks 0 to n - 1 (an address),
        for a traced graph's mark nodes to record."""
        return self._events.marks(n)

    def run_eager(self, body, load):
        """An eager call: load() (the inputs on the device), then body over
        them with its stages marked as events of this call."""
        with self.span("ph2.load"):
            self.event(CALL_START)
            args = load()
        if self._events is None:
            stages = Stages(lambda i: self._times.__setitem__(MARKS + i, time.perf_counter()))
        else:
            def mark(i):
                self._events.reserve(MARKS + i + 1)  # an eager body's marks: made as it needs them
                self._events.record(MARKS + i)
            stages = Stages(mark)
        out = stages.run(body, *args)
        self.event(CALL_END)
        self.plan = stages.plan
        return out

    # -- after calls() -------------------------------------------------------
    def stage_ms(self, name: str) -> float:
        return sum(s.ms for s in self.stages if s.name == name)

    def self_ms(self, name: str) -> float:
        """A stage's ms (every instance of it) less its children's."""
        own = [i for i, s in enumerate(self.stages) if s.name == name]
        return sum(self.stages[i].ms for i in own) - sum(s.ms for s in self.stages if s.parent in own)

    def top_ms(self) -> float:
        return sum(s.ms for s in self.stages if s.parent is None)

    def _harvest(self, clock: _Clock | None, scale: float):
        if not self._timed:
            return
        # the last mark (Stages.end's) ends the last top-level stage; a body with no stage has marks 0 and 1
        n = 1 + max((p[3] for p in self.plan), default=1)
        if self._events is None:
            t = self._times
            self.device = {name: t[k] for k, name in enumerate(DEVICE_EVENTS)}
            marks = [t[MARKS + i] for i in range(n)]

            def ms(a, b):
                return (marks[b] - marks[a]) * 1e3
        else:
            ev = self._events.events
            t0 = clock.to_host(ev[0], scale)
            self.device = {name: t0 + ev[0].elapsed_time(ev[k]) / 1e3 * scale for k, name in enumerate(DEVICE_EVENTS)}
            marks = [t0 + ev[0].elapsed_time(ev[MARKS + i]) / 1e3 * scale for i in range(n)]

            def ms(a, b):
                return ev[MARKS + a].elapsed_time(ev[MARKS + b])
        self.device["graph_start"], self.device["graph_end"] = marks[0], marks[-1]
        self.graph_ms = ms(0, n - 1)
        self.stages = [Stage(name, parent, marks[a], marks[b], ms(a, b)) for name, parent, a, b in self.plan or ()]
        self._timed = False  # harvested; the slot's events may be reused
        self._events = None
        self._times = {}


class Recorder:
    """The process's ring of traced calls (see the module's docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self.overwritten = 0
        self._slots: list = [None] * capacity
        self._ids = itertools.count()
        self._sets: dict = {}  # card index -> [_EventSet] a slot
        self._clocks: dict = {}  # card index -> _Clock

    @contextmanager
    def call(self, entry: str, device: torch.device):
        """One entry call's record, its ``ph2.call`` span open throughout."""
        cid = next(self._ids)
        slot = cid % self.capacity
        if self._slots[slot] is not None:
            self.overwritten += 1
        card = events = None
        if device.type == "cuda":
            card = _card(device)
            sets = self._sets.get(card)
            if sets is None:
                sets = self.prepare(device, MARKS)
            events = sets[slot]
        c = self._slots[slot] = Call(cid, entry, card, events)
        with c.span("ph2.call"):
            yield c

    def prepare(self, device: torch.device, n_events: int) -> list:
        """Ready a card for traced calls of up to n_events events each: its
        clock's first reference and every slot's event set (set-up work,
        which synchronises)."""
        index = _card(device)
        with torch.cuda.device(index):
            if index not in self._clocks:
                self._clocks[index] = _Clock(torch.device("cuda", index))
                self._clocks[index].calibrate()
            sets = self._sets.setdefault(index, [_EventSet(index) for _ in range(self.capacity)])
            for s in sets:
                s.reserve(n_events)
        return sets

    def calls(self) -> list[Call]:
        """The ring's calls in order, every device time harvested: synchronises
        each card once and takes a clock reference there. Not for the hot
        path."""
        scales = {}
        for index, clock in self._clocks.items():
            clock.calibrate()
            scales[index] = clock.scale
        out = sorted((c for c in self._slots if c is not None), key=lambda c: c.id)
        for c in out:
            c._harvest(self._clocks.get(c.card), scales.get(c.card, 1.0))
        return out

    def clock(self) -> dict:
        """Each card's calibration: references taken, uncertainty (s, half
        the tightest host bracket) and drift (host s per device s, less 1)."""
        return {i: {"references": len(c.refs), "uncertainty_s": c.uncertainty, "drift": c.scale - 1}
                for i, c in self._clocks.items()}

    def clear(self):
        """Forget every call (the event sets and clocks stay)."""
        self._slots = [None] * self.capacity
        self.overwritten = 0


def _card(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


RECORDER = Recorder()


def enable():
    RECORDER.on = True


def disable():
    RECORDER.on = False


def enabled() -> bool:
    return RECORDER.on


def calls() -> list[Call]:
    return RECORDER.calls()


# -- verification values ------------------------------------------------------
def format_traces(traces: dict) -> str:
    lines = []
    for key, val in traces.items():
        if isinstance(val, tuple) and len(val) == 2:  # G1 point
            lines.append(f"{key}: G1(x={val[0]:#x}, y={val[1]:#x})")
        elif isinstance(val, int):
            lines.append(f"{key}: {val:#x}")
        else:
            lines.append(f"{key}: {val}")
    return "\n".join(lines)


def diff_traces(a: dict, b: dict) -> list[str]:
    """Keys whose values differ (present in both)."""
    out = []
    for k in a:
        if k in b and a[k] != b[k]:
            out.append(k)
    return out


def device_traces(verifier, proof_bytes, public_inputs, y_hints=None, sub_weights=None) -> list[dict]:
    """The spec's pairing-side traces as the batched verifier computes them:
    per row, {"el": el, "er": -er} of ``verifier.core`` (a TorchVerifier) as
    affine points (None for the identity), ready for ``diff_traces``
    against ``refimpl.verifier.verify(..., collect_traces=True)``."""
    from ..ops import curve as tc

    el, er, _valid = verifier.core(proof_bytes, public_inputs, y_hints, sub_weights)
    el, er = el.cpu().numpy(), tc.neg(er).cpu().numpy()
    return [{"el": tc.host_point_from_mont(el[b]), "er": tc.host_point_from_mont(er[b])}
            for b in range(el.shape[0])]
