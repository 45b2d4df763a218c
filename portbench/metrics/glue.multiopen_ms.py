"""glue.multiopen_ms: the median device ms of the ``multiopen`` stage less
its ``msm`` children (the multi-open MSM kernel calls): the multi-open's
plain-torch glue, with its final negation and copies, timed by the stage
nodes of the graph users run, over the window's calls issued before the
traced sub-window."""

from portbench import spans

LAYER = "plain-torch glue (models/verifier_torch.py Fr side and multi-open over ops/limb.py, ops/curve.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def read(ctx):
    return spans.median(c.self_ms("multiopen") for _r, c in spans.window(ctx) if c.stage_ms("multiopen"))
