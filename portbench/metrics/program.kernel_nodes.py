"""program.kernel_nodes: the kernel nodes of the cell's CUDA graph, as the
port counts them at capture (``Program.nodes``, by the graph's node
types): the in-program count of the kernels a batch runs."""

from portbench import spans

LAYER = "programs and entry (models/programs.py staging, replay, clone; models/verifier_torch.py host checks)"
UNIT = "nodes"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "batch_p95_ms"


def read(ctx):
    counts = {c.nodes["kernel"] for _r, c in spans.window(ctx) if c.nodes}
    return max(counts) if counts else None
