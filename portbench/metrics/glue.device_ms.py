"""glue.device_ms: device ms a batch in which some traced kernel ran that
is not one of the port's hand-written kernels (csrc/*.cu, named in
CSRC_KERNELS): the plain-torch glue of the Fr side and the multi-open. The
union of those kernels' intervals, not the sum of their durations: a CUDA
graph runs independent kernels side by side (the durations of one batch's
glue kernels summed to 110 ms in a 77 ms batch on an H100)."""

from portbench.trace import busy_us

LAYER = "plain-torch glue (models/verifier_torch.py Fr side and multi-open over ops/limb.py, ops/curve.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "proofs_per_s"
# the kernels of plutus_halo2_tpu_torch/csrc/*.cu, as their names hold them
CSRC_KERNELS = ("transcript_kernel", "pow_kernel", "msm_kernel", "pairing_kernel", "decompress_kernel",
                "decompress_subgroup_kernel", "subgroup_kernel", "mont_mul_kernel", "fp_step_probe",
                "lanes_step_probe", "int8_dot_kernel", "int8_chain_kernel", "bf16_chain_kernel", "fr_powers_tab_kernel", "fr_twiddle_kernel", "fr_bitrev_kernel",
                "fr_ntt_stage_kernel", "fr_mul_array_kernel", "fr_scale_kernel", "fr_powers_mul_kernel")
# the kernels of csrc/*.cu that do the glue's own work (the Fr ops of ops/limb.py, the hintless decode
# of ops/curve.decompress), so they count as glue; only the test of the two lists reads this one
GLUE_KERNELS = ("fr_glue_mul", "fr_glue_add", "fr_glue_sub", "fr_glue_sum", "fr_glue_dot", "sqrt_decode_kernel")


def glue(kernels):
    return [k for k in kernels if not any(n in k[0] for n in CSRC_KERNELS)]


def read(ctx):
    if ctx.trace is None:
        return None
    g = glue(ctx.trace.kernels)
    return busy_us(g) / 1e3 / ctx.trace.batches if g else None
