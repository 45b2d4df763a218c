"""program.device_ms: the median device ms between each call's
``graph_start`` and ``graph_end`` (its first and last stage marks, CUDA
events: the graph's replay on the card), over the window's calls issued
before the traced sub-window.

Its reading also notes (``ctx.note``): the calls split by the harness's
[slow] rule (latency over 1.08 x the window's median) with each group's
medians of this, ``host.launch_ms``, ``program.queue_ms``, the gap before
the call and each top-level stage; the gaps between the calls on the card, each
named by the port's host span open at its middle (``ph2.load``,
``ph2.launch``, other ``ph2.call`` time, or the harness's); and the
trace's health: the clock's calibration, calls whose mapped events break
causality (``call_start`` before its ``ph2.call`` span's start, or
``call_end`` after the harness had the verdicts, beyond the calibration's
uncertainty), the largest gap between a call's top-level stages and its
graph's span, records overwritten, and captures after the warm-up."""

from portbench import spans

LAYER = "programs and entry (models/programs.py staging, replay, clone; models/verifier_torch.py host checks)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def _fmt(x, digits=3):
    return "n/a" if x is None else f"{x:.{digits}f}"


def speeds(ctx, pairs) -> list[str]:
    lat = [(r.t_done - r.t_issue) * 1e3 for r, _c in pairs]
    cut = spans.SLOW * spans.median((r.t_done - r.t_issue) * 1e3 for r in ctx.window)  # as the [slow] line
    before = [None] + [max(0.0, b.device["call_start"] - a.device["call_end"]) * 1e3
                       for (_r0, a), (_r1, b) in zip(pairs, pairs[1:])]
    tops = list(dict.fromkeys(s.name for s in pairs[0][1].stages if s.parent is None))
    lines = []
    for label, keep in (("slow", lambda x: x > cut), ("fast", lambda x: x <= cut)):
        idx = [i for i, x in enumerate(lat) if keep(x)]
        if not idx:
            lines.append(f"[spans] speeds: {label}: no call")
            continue
        calls = [pairs[i][1] for i in idx]
        stages = ", ".join(f"{n} {_fmt(spans.median(c.stage_ms(n) for c in calls))}" for n in tops)
        lines.append(
            f"[spans] speeds: {label} (latency {'over' if label == 'slow' else 'at most'} {cut:.3f} ms): "
            f"{len(idx)} calls, calls {idx[0]}-{idx[-1]}; device {_fmt(spans.median(c.graph_ms for c in calls))} ms, "
            f"launch {_fmt(spans.median(spans.launch_ms(c) for c in calls))}, queue "
            f"{_fmt(spans.median(spans.queue_ms(ctx, c) for c in calls))}, gap before "
            f"{_fmt(spans.median(before[i] for i in idx))}, latency {_fmt(spans.median(lat[i] for i in idx))}; "
            f"stages (ms) {stages}")
    return lines


def _open_at(all_calls, t) -> str:
    """The innermost of the port's host spans open at host time t."""
    for c in all_calls:
        if c.spans and c.spans[0].start <= t <= (c.spans[0].end or t):
            inner = [s.name for s in c.spans[1:] if s.start <= t <= s.end]
            return inner[-1] if inner else "ph2.call"
    return "harness"


def gap_note(ctx, pairs) -> str:
    found = spans.gaps(pairs)
    by = {}
    for a, b in found:
        name = _open_at(spans.calls(ctx), (a + b) / 2)
        n, ms = by.get(name, (0, 0.0))
        by[name] = (n + 1, ms + (b - a) * 1e3)
    span = (pairs[-1][1].device["call_end"] - pairs[0][1].device["call_start"]) * 1e3
    total = sum(ms for _n, ms in by.values())
    parts = ", ".join(f"{k} {n} gaps {ms:.3f} ms" for k, (n, ms) in sorted(by.items(), key=lambda kv: -kv[1][1]))
    longest = max(((b - a) * 1e3 for a, b in found), default=0.0)
    return (f"[spans] gaps between the port's calls on the card: {len(found)} gaps, {total:.3f} ms of "
            f"{span:.3f} ms ({100 * total / span:.3f} %), longest {longest:.3f} ms; by the host span open at "
            f"their middle: {parts or 'none'}")


def health(ctx, pairs) -> str:
    rec = spans.recorder()
    clock = next(iter(rec.clock().values()), None) if rec is not None else None
    unc = clock["uncertainty_s"] if clock else 0.0
    early = sum(c.device["call_start"] < c.spans[0].start - unc for _r, c in pairs)
    late = sum(c.device["call_end"] > r.t_done + unc for r, c in pairs)
    off = [abs(c.top_ms() - c.graph_ms) / c.graph_ms for _r, c in pairs if c.stages and c.graph_ms]
    start = ctx.window[0].t_issue if ctx.window else float("inf")
    late_captures = sum(c.captured and c.spans[0].start >= start for c in spans.calls(ctx))
    clock_text = "no clock" if clock is None else (
        f"clock: {clock['references']} references, uncertainty {clock['uncertainty_s'] * 1e6:.3f} us, "
        f"drift {clock['drift'] * 1e6:.3f} ppm")
    return (f"[spans] health: {clock_text}; causality: {early} call_start before their ph2.call, {late} call_end "
            f"after the harness's verdicts, of {len(pairs)} calls; top-level stages against the graph's span: "
            f"at most {100 * max(off, default=0.0):.3f} % apart; {rec.overwritten if rec else 0} records "
            f"overwritten; {late_captures} captures after the warm-up; {len(spans.calls(ctx))} calls recorded")


def read(ctx):
    pairs = spans.window(ctx)
    if not pairs:
        return None
    for line in speeds(ctx, pairs):
        ctx.note(line)
    if len(pairs) > 1:
        ctx.note(gap_note(ctx, pairs))
    ctx.note(health(ctx, pairs))
    return spans.median(c.graph_ms for _r, c in pairs)
