"""setup_s: the process's start (the harness's first line) to the window's
first call: imports, the kernels' build on a checkout's first run, the
verifier's host constants, input generation, and the warm-up that captures
the cell's one CUDA graph and replays it."""

LAYER = "end to end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
