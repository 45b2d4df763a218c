"""multiopen.device_ms: the median device ms of the whole ``multiopen``
stage, its glue and every multi-open MSM kernel call (under GWC19 the
left side's ``msm_w`` and the right side's ``msm``), timed by the stage
nodes of the graph users run, over the window's calls issued before the
traced sub-window. Notes the median device ms of every stage beside it."""

import statistics

from portbench import spans

LAYER = "MSM kernel (ops/cuda_curve.py msm -> csrc/msm.cu)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def read(ctx):
    calls = [c for _r, c in spans.window(ctx) if c.stage_ms("multiopen")]
    if not calls:
        return None
    names = list(dict.fromkeys(s.name for s in calls[0].stages))
    ctx.note("[spans] stages, median device ms of " + f"{len(calls)} calls: " + ", ".join(
        f"{n} {statistics.median(c.stage_ms(n) for c in calls):.3f} (self "
        f"{statistics.median(c.self_ms(n) for c in calls):.3f})" for n in names))
    return spans.median(c.stage_ms("multiopen") for c in calls)
