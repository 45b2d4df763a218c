"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, entry point and metrics are files found by
name (``spec.py``). A run:

1. set-up: makes every input from the seed (``traffic.py``: the committed
   proof, seeded invalid variants at seeded rows, y-hints, RLC weights),
   builds the port's verifier, and warms up: ``in_flight`` calls issued
   back to back and read, twice, which captures the cell's one CUDA graph
   and replays it. ``setup_s`` runs from the start of this module to the
   window's first call;
2. the window: a closed loop of ``in_flight`` calls in flight for
   ``--seconds``: the oldest call's verdict vector is read back to the host
   (numpy; the entry queues its copy right behind the call) before the next
   call is issued in its place; the calls in flight at the close are read
   after it. With ``--trace 1`` a sub-window of
   ``trace_batches`` whole batches, a third of the way in, runs under the
   profiler (``trace.py``);
3. after the window: the peak device memory is read, the port's state is
   freed, and the plain reference (``reference/verifier.py``, which imports
   nothing of the port) judges every verdict the calls returned
   (``check.py``).

Prints the checks as the last lines of standard error and, as the last line
of standard output, one JSON object: ``correct``, ``attempted`` and
``failed`` (proofs), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
``checks`` last. Exits non-zero and prints no result without enough CUDA
devices, or when ``jax``, ``jaxlib``, ``flax`` or ``plutus_halo2_tpu`` is
loaded once the window has closed."""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # setup_s counts from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "plutus_halo2_tpu")  # top-level module names, compared whole
WARMUP_ROUNDS = 2
THREADS = 1  # the host's torch threads: one process with few threads keeps runs steady
TRACE_AT = 1 / 3  # the traced sub-window starts this far into the window


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Record:
    """One call: its layout, host clock at its issue, at the issue's return
    and once its verdicts were on the host, and the verdicts."""

    layout: int
    t_issue: float
    t_issued: float
    t_done: float | None = None
    verdicts: object = None
    warmup: bool = False


class Loop:
    """A closed loop of `depth` calls in flight over the layouts' batches."""

    def __init__(self, entry, batches, depth: int):
        self.entry, self.batches, self.depth = entry, batches, depth
        self.pending: deque = deque()
        self.records: list[Record] = []
        self.next = 0
        self.warmup = self.traced = False

    def _span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def issue(self):
        li = self.next % len(self.batches)
        self.next += 1
        t0 = time.perf_counter()
        with self._span("portbench.issue"):
            handle = self.entry.issue(self.batches[li])
        rec = Record(li, t0, time.perf_counter(), warmup=self.warmup)
        self.pending.append((rec, handle))
        self.records.append(rec)

    def finish_oldest(self):
        rec, handle = self.pending.popleft()
        with self._span("portbench.finish"):
            rec.verdicts = self.entry.finish(handle)
        rec.t_done = time.perf_counter()

    def drain(self):
        while self.pending:
            self.finish_oldest()

    def run_until(self, t_end: float):
        """Keep `depth` calls in flight until t_end, then read the rest."""
        while True:
            while len(self.pending) < self.depth and time.perf_counter() < t_end:
                self.issue()
            if not self.pending:
                return
            self.finish_oldest()

    def run_batches(self, n: int) -> list[int]:
        """Exactly n calls through the loop, all read; their layouts."""
        first = len(self.records)
        for _ in range(n):
            if len(self.pending) == self.depth:
                self.finish_oldest()
            self.issue()
        self.drain()
        return [r.layout for r in self.records[first:]]


@dataclass
class Context:
    """What the metric readers read (``metrics/<name>.py``: ``read(ctx)``)."""

    batch: int
    seconds: float
    setup_s: float
    t_end: float
    records: list
    trace: object = None
    t_trace: float | None = None  # host clock at the traced sub-window's start
    work: dict = field(default_factory=dict)  # layout -> roofline.batch_work of a traced layout
    notes: list = field(default_factory=list)

    def note(self, text: str):
        self.notes.append(text)

    @property
    def window(self) -> list:
        """The window's calls (not the warm-up's)."""
        return [r for r in self.records if not r.warmup]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0].strip() if out.stdout.strip() else "nvidia-smi: no output"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", wrap_entry=None,
             log=print) -> dict:
    """One run of `cell` (spec.Cell); returns the result (last key
    ``checks``). ``wrap_entry`` (tests) wraps the entry to break the timed
    path underneath."""
    import torch

    from . import check, program, roofline, traffic
    from .reference.verifier import verify as reference_verify

    t = cell.traffic
    stamps = [("start", time.perf_counter())]
    gen = traffic.generate(cell.config, cell.circuit(), t, seed, cell.artifacts)
    stamps.append(("inputs", time.perf_counter()))
    dev = torch.device(device)
    verifier = program.verifier(cell.config, t, gen.vk_json, dev)
    stamps.append(("verifier", time.perf_counter()))
    generator = torch.Generator().manual_seed(seed % (1 << 63))
    entry = cell.entry().Entry(verifier, t, generator)
    if wrap_entry is not None:
        entry = wrap_entry(entry)
    loop = Loop(entry, program.batches(gen), int(t["in_flight"]))

    loop.warmup = True
    for _ in range(WARMUP_ROUNDS):
        for _ in range(loop.depth):
            loop.issue()
        loop.drain()
    loop.warmup = False
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections

    t_start = time.perf_counter()
    setup_s = t_start - _T0
    stamps.append(("warm-up", t_start))
    log("[setup] " + ", ".join(f"{name} {b - a:.3f} s" for (_n, a), (name, b)
                               in zip([("", _T0)] + stamps, stamps)) + f"; {setup_s:.3f} s in all", file=sys.stderr)
    t_end = t_start + seconds
    shot = tr = t_trace = None
    if trace:
        from . import trace as tracing

        loop.run_until(t_start + seconds * TRACE_AT)
        t_trace = time.perf_counter()
        loop.traced = True
        shot = tracing.record(loop.run_batches, int(t["trace_batches"]))
        loop.traced = False
    loop.run_until(t_end)
    t_closed = time.perf_counter()

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    while shot is not None:
        tr = tracing.read(shot)
        if tr is not None:
            break
        if shot[2] == tracing.ATTEMPTS:
            raise RuntimeError(f"the profiler gave no whole sub-window in {tracing.ATTEMPTS} attempts")
        log(f"[trace] attempt {shot[2]}: the sub-window was not whole; traced again", file=sys.stderr)
        loop.traced = True
        shot = tracing.record(loop.run_batches, int(t["trace_batches"]), shot[2] + 1)
        loop.traced = False
    del loop.entry, loop.batches, entry, verifier
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    outcomes = [reference_verify(gen.plan, p, gen.public_inputs) for p in gen.distinct]
    log(f"[reference] {len(outcomes)} distinct inputs in {time.perf_counter() - t_ref:.3f} s: "
        + ", ".join(f"{k}:{o.stage}" for k, o in zip(gen.kinds, outcomes)), file=sys.stderr)
    numbers = check.compare(loop.records, check.expected_verdicts(gen.layouts, outcomes))
    correct, checks = check.judged(numbers)

    B = int(t["batch"])
    ctx = Context(B, seconds, setup_s, t_end, loop.records, tr, t_trace)
    if tr is not None:
        group = t.get("rlc_group")
        for li in set(tr.layouts):
            lay = gen.layouts[li]
            ctx.work[li] = roofline.batch_work(t["entry"], lay.rows, outcomes, lay.rlc_weights, group)
    metrics = {}
    for m, mod in cell.metrics:
        value = mod.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for n in ctx.notes:
        log(n, file=sys.stderr)
    window = ctx.window
    issue_ms = sorted((r.t_issued - r.t_issue) * 1e3 for r in window) or [0.0]
    log(f"[window] {len(window)} calls of {B} proofs in {seconds} s (closed {t_closed - t_end:.3f} s after "
        f"the close), {sum(r.t_done <= t_end for r in window)} read inside it; warm-up {len(loop.records) - len(window)} "
        f"calls; issue median {issue_ms[len(issue_ms) // 2]:.3f} ms; set-up {setup_s:.3f} s", file=sys.stderr)
    lat = [(r.t_done - r.t_issue) * 1e3 for r in window]
    if lat:
        cut = 1.08 * sorted(lat)[len(lat) // 2]
        slow = [i for i, x in enumerate(lat) if x > cut]
        log(f"[slow] {len(slow)} of {len(lat)} calls over 1.08 x the median latency, at call "
            f"{slow[:40]}; their layouts {[window[i].layout for i in slow[:40]]}", file=sys.stderr)

    result = {
        "correct": bool(correct),
        "attempted": B * len(loop.records),
        "failed": numbers["wrong_verdicts"] + numbers["unanswered"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)},
    }
    if tr is not None:
        from .trace import breakdown, busy_us

        result["device"]["busy_s"] = busy_us(tr.device) / 1e6
        result["device"]["window_s"] = tr.window_us / 1e6
        result["breakdown"] = breakdown(tr)
        log(f"[trace] {tr.batches} batches (layouts {tr.layouts}), {len(tr.kernels)} kernels, "
            f"{len(tr.device)} device records, window {tr.window_us / 1e3:.3f} ms, attempt {tr.attempts}",
            file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from . import spec

    torch.set_num_threads(THREADS)
    cell = spec.cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(f"[card] {card_line()}", file=sys.stderr)  # after the window: a diagnostic, not set-up
    found = forbidden_modules()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the run's process", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        rule = "max" if "max" in c else "min"
        print(f"check {name} {c['value']} {rule} {c[rule]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
