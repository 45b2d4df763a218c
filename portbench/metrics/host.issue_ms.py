"""host.issue_ms: the median host-clock span of the entry's call until it
returns (the port's input checks, the staging copies, the graph's launch
and the output clones, and the harness's queued readback copy), over the
window's calls issued before the traced sub-window of a --trace 1 run.
Under the profiler a launch of the ~20,000-34,000-node graph takes up to
100 ms of host time (an H100), and calls after the sub-window still run
slower, so neither would time the port's host path."""

import statistics

LAYER = "programs and entry (models/programs.py staging, replay, clone; models/verifier_torch.py host checks)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "batch_p95_ms"


def read(ctx):
    if ctx.t_trace is None:
        return None
    spans = [(r.t_issued - r.t_issue) * 1e3 for r in ctx.window if r.t_issue < ctx.t_trace]
    return statistics.median(spans) if spans else None
