"""host.launch_ms: the median ``ph2.launch`` span of the port's calls (its
graph's replay alone, ``models/programs.py``; host clock), over the
window's calls issued before the traced sub-window (``spans.window``)."""

from portbench import spans

LAYER = "programs and entry (models/programs.py staging, replay, clone; models/verifier_torch.py host checks)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "batch_p95_ms"


def read(ctx):
    return spans.median(spans.launch_ms(c) for _r, c in spans.window(ctx))
