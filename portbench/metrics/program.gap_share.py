"""program.gap_share: the share of the window's calls' device span (the
first call's ``call_start`` to the last one's ``call_end``, CUDA events)
in which the card ran nothing of the port's, sum over consecutive calls
of max(0, call_start(n + 1) - call_end(n)): the idle between the port's
calls, untraced by the profiler, over the window's calls issued before
the traced sub-window."""

from portbench import spans

LAYER = "programs and entry (models/programs.py staging, replay, clone; models/verifier_torch.py host checks)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def read(ctx):
    pairs = spans.window(ctx)
    if len(pairs) < 2:
        return None
    span = pairs[-1][1].device["call_end"] - pairs[0][1].device["call_start"]
    return 100 * sum(b - a for a, b in spans.gaps(pairs)) / span
