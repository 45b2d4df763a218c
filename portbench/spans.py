"""The port's own trace (``plutus_halo2_tpu_torch/utils/tracing.py``), as
the per-layer metrics of its programs read it: host spans, CUDA-event
device intervals and stage marks on the host's clock, and each program's
node census.

Importing this module turns the port's recorder on. ``spec.cell`` loads
the per-layer metrics' modules, which import this one, only for a
``--trace 1`` run, and before the run builds the verifier: a traced run
therefore records from the first capture (the cell's graph is captured
with its stage nodes), and a ``--trace 0`` run (the end-to-end runs) loads
none of these modules and runs with tracing off. The switch could move
into ``run.py``.

``window(ctx)`` pairs each call of the window that the harness issued
before the traced sub-window (``ctx.t_trace``, as ``host.issue_ms``: the
profiler slows the calls under it and after it) with the port's record of
it. A port without the recorder (its tracing module has no ``enable`` or
``RECORDER``) gives no pairs, and the readers nothing."""

from __future__ import annotations

import statistics

from plutus_halo2_tpu_torch.utils import tracing

if getattr(tracing, "enable", None) is not None:
    tracing.enable()

SLOW = 1.08  # the harness's [slow] rule: latency over this times the median


def recorder():
    return getattr(tracing, "RECORDER", None)


def calls(ctx) -> list:
    """Every call the port recorded in this run (read once a run)."""
    if "port_calls" not in ctx.__dict__:
        rec = recorder()
        ctx.port_calls = [] if rec is None else rec.calls()
    return ctx.port_calls


def window(ctx) -> list:
    """[(harness Record, port Call)] of the window's calls issued before
    the traced sub-window, in order: each harness call holds the one port
    call whose ``ph2.call`` span starts inside its issue."""
    if "port_window" in ctx.__dict__:
        return ctx.port_window
    pairs = []
    if ctx.t_trace is not None:
        timed = [c for c in calls(ctx) if c.device is not None]
        i = 0
        for r in ctx.window:
            if r.t_issue >= ctx.t_trace:
                break
            while i < len(timed) and timed[i].spans[0].start < r.t_issue:
                i += 1
            if i < len(timed) and timed[i].spans[0].start <= r.t_issued:
                pairs.append((r, timed[i]))
                i += 1
    ctx.port_window = pairs
    return pairs


def median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def launch_ms(call):
    s = call.span_named("ph2.launch")
    return None if s is None else s.ms


def previous(ctx, call):
    """The call the port recorded just before `call`, if any."""
    if "port_by_id" not in ctx.__dict__:
        ctx.port_by_id = {c.id: c for c in calls(ctx)}
    return ctx.port_by_id.get(call.id - 1)


def queue_ms(ctx, call):
    """graph_start on the host clock less the later of the call's start
    and the previous call's graph_end: the port's own staging before its
    graph starts, without the wait behind the graph ahead of it."""
    start = call.spans[0].start
    prev = previous(ctx, call)
    if prev is not None and prev.device is not None:
        start = max(start, prev.device["graph_end"])
    return (call.device["graph_start"] - start) * 1e3


def gaps(pairs) -> list:
    """(start s, end s) of each stretch between one call's call_end and the
    next call's call_start with nothing of the port's on the card."""
    out = []
    for (_r0, a), (_r1, b) in zip(pairs, pairs[1:]):
        if b.device["call_start"] > a.device["call_end"]:
            out.append((a.device["call_end"], b.device["call_start"]))
    return out
