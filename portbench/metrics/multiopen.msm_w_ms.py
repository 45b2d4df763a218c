"""multiopen.msm_w_ms: the median device ms of the ``msm_w`` stage, the
GWC19 multi-open's left-side MSM kernel call (the W_i), timed by the
stage nodes of the graph users run, over the window's calls issued before
the traced sub-window. A port without that stage gives nothing."""

from portbench import spans

LAYER = "MSM kernel (ops/cuda_curve.py msm -> csrc/msm.cu)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def read(ctx):
    return spans.median(c.stage_ms("msm_w") for _r, c in spans.window(ctx) if c.stage_ms("msm_w"))
