"""glue.kernels_per_batch: device kernel records a batch that are not the
port's hand-written kernels (the list is glue.device_ms's CSRC_KERNELS)."""

from portbench.spec import metric_module

LAYER = "plain-torch glue (models/verifier_torch.py Fr side and multi-open over ops/limb.py, ops/curve.py)"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "batch_p95_ms"


def read(ctx):
    if ctx.trace is None:
        return None
    g = metric_module("glue.device_ms").glue(ctx.trace.kernels)
    return len(g) / ctx.trace.batches if g else None
