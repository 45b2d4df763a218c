"""program.queue_ms: the median of each call's ``graph_start`` (its first
stage mark, a CUDA event mapped onto the host's clock) less the later of
the start of its ``ph2.call`` span and the previous call's ``graph_end``:
the port's own part before its graph starts (input checks, staging,
launch, and the previous call's clones on the card), without the wait
behind the graph ahead of it, over the window's calls issued before the
traced sub-window."""

from portbench import spans

LAYER = "programs and entry (models/programs.py staging, replay, clone; models/verifier_torch.py host checks)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "batch_p95_ms"


def read(ctx):
    return spans.median(spans.queue_ms(ctx, c) for _r, c in spans.window(ctx))
