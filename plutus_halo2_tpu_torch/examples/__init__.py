"""The port's example scripts, the counterpart of ``examples/*.py`` and of
the reference's ``cargo run --example ...``: keygen, prove, verify with the
spec verifier and through ``TorchVerifier``, write the artifact set.

    python3 -m plutus_halo2_tpu_torch.examples.simple_mul [gwc_kzg] [--cpu] [--out DIR]
    python3 -m plutus_halo2_tpu_torch.examples.lookup_table [gwc_kzg] [--cpu] [--out DIR]
    python3 -m plutus_halo2_tpu_torch.examples.atms [gwc_kzg] [--lookups] [--parties N] [--threshold T]
        [--cpu] [--out DIR]
    python3 -m plutus_halo2_tpu_torch.examples.equations_test [--atms] [--cpu] [--out DIR]

Each proves and verifies on the card unless ``--cpu`` asks for the plain
versions, and writes into ``--out`` (default ``chiprun_out/examples/`` in
the repository), never into ``examples/artifacts/``."""
