"""kernels.pairing_roofline: the least time of the traced batches' pairing
checks (roofline.batch_work: the larger of their 32-bit integer operations
over 1.67e13/s and their bytes over 3.35e12 B/s) over the device time of
the pairing kernel's launches in the traced sub-window, in %. The
operations are counted at what the batch's inputs need, with the
reference's live points; nothing here depends on how the kernel is
written."""

from portbench.roofline import share

LAYER = "pairing kernel (ops/cuda_pairing.py -> csrc/pairing.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "proofs_per_s"


def read(ctx):
    return share(ctx, "pairing_kernel", "pairing", "pairing")
