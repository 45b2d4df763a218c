"""decode.device_ms: the median device ms of the ``decompress`` stage (the
proof's scalars parsed and its points decoded: the fused decompress and
subgroup kernel with y-hints, the sqrt ladder's kernel without) plus the
``subgroup`` stage where a call has one (the unfused aggregate subgroup
test of the hintless path), timed by the stage nodes of the graph users
run, over the window's calls issued before the traced sub-window."""

from portbench import spans

LAYER = ("point decoding (ops/cuda_curve.py decompress, decompress_hintless, subgroup checks -> "
         "csrc/decompress.cu, sqrt_decode.cu, subgroup.cu)")
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proofs_per_s"


def read(ctx):
    return spans.median(c.stage_ms("decompress") + c.stage_ms("subgroup")
                        for _r, c in spans.window(ctx) if c.stage_ms("decompress"))
