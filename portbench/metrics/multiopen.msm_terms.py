"""multiopen.msm_terms: the de-duplicated terms of the multi-open's MSM
calls a row, summed over the calls (under GWC19 the left side's and the
right side's), as the port counts them when it captures the cell's graph
(``Program.msm_term_counts``, carried on each traced call as
``msm_terms``). A port that carries no counts gives nothing."""

from portbench import spans

LAYER = "MSM kernel (ops/cuda_curve.py msm -> csrc/msm.cu)"
UNIT = "terms"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "proofs_per_s"


def read(ctx):
    counts = {sum(c.msm_terms) for _r, c in spans.window(ctx) if getattr(c, "msm_terms", None)}
    return max(counts) if counts else None
