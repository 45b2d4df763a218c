"""proofs_per_s: proofs whose verdicts reached the host inside the window,
over the window's seconds: all the window's work over all its time."""

LAYER = "end to end"
UNIT = "proofs/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    done = sum(ctx.batch for r in ctx.window if r.t_done is not None and r.t_done <= ctx.t_end)
    return done / ctx.seconds
