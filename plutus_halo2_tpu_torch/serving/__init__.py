"""Serving layer — the analog of the reference's on-chain submitter
(aiken-verifier/submitter/src/main.rs:39-225), the port of
``plutus_halo2_tpu/serving``.

The reference packages (proof, public inputs) into a Cardano transaction whose
NFT name is blake2b_256(proof ∥ inputs) (main.rs:96-99), submits it via
Blockfrost, and polls for confirmation (api.rs:52-80). Here the "chain" is a
GPU: `VerificationService` accumulates submitted bundles into fixed-size
device batches, dispatches TorchVerifier, and resolves per-bundle futures;
the same blake2b tag identifies each submission."""

from .service import ProofBundle, VerificationService

__all__ = ["ProofBundle", "VerificationService"]
