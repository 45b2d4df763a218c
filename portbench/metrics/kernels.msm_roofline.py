"""kernels.msm_roofline: the least time of the traced batches' MSMs, every
launch of the batch (the multi-open's and the RLC aggregation's), over
the MSM kernel's device time in the traced sub-window, in %. Terms come
from the reference's merged multi-open terms of each decoded input and
from the batch's RLC weights (roofline.batch_work)."""

from portbench.roofline import share

LAYER = "MSM kernel (ops/cuda_curve.py msm -> csrc/msm.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "proofs_per_s"


def read(ctx):
    return share(ctx, "msm_kernel", "msm", "msm")
