"""batch_p95_ms: the 95th percentile, over every call of the window (those
read after the close too), of the host-clock time from the call's issue to
its verdict vector on the host. The median and the number of calls go on
an earlier line of standard error."""

import numpy as np

LAYER = "end to end"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    ms = np.array([(r.t_done - r.t_issue) * 1e3 for r in ctx.window if r.t_done is not None])
    if not len(ms):
        return None
    p95 = float(np.percentile(ms, 95))
    ctx.note(f"[batch_ms] n {len(ms)}, median {float(np.median(ms)):.4f}, p95 {p95:.4f}, "
             f"calls beyond the p95 {int((ms > p95).sum())}, max {float(ms.max()):.4f}")
    return p95
