"""glue.fr_side_ms: the median device ms of the ``fr_side`` stage less its
child ``fr_pow`` (the Fr pow kernel at the batch inversion's root): the
plain-torch Fr glue of ``TorchVerifier._scalar_side``, timed by the stage
nodes of the graph users run, over the window's calls issued before the
traced sub-window."""

from portbench import spans

LAYER = "plain-torch glue (models/verifier_torch.py Fr side and multi-open over ops/limb.py, ops/curve.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def read(ctx):
    return spans.median(c.self_ms("fr_side") for _r, c in spans.window(ctx) if c.stage_ms("fr_side"))
