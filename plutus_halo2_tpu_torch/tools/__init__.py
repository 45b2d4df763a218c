"""The port's probes: ``mma_probe`` (tensor-core products of the shape of a
Montgomery reduction by a constant) and ``perf_probe`` (per-stage times of
the verifier). Run each with ``python3 -m plutus_halo2_tpu_torch.tools.<name>``."""
