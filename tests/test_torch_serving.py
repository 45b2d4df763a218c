"""The port's VerificationService (plutus_halo2_tpu_torch/serving) as
tests/test_serving.py holds the JAX one: the submission tag is the
reference's NFT-name derivation, honest and tampered bundles resolve to
their verdicts across a full and a padded batch (per-proof pairing and RLC
groups), a wrong expected_tag resolves to (tag, False) without the device,
malformed bundles resolve to exceptions, and the service refuses an
rlc_group that does not divide its batch and a missing GPU."""

import hashlib
import os

import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.serving import ProofBundle as JProofBundle  # noqa: E402
from plutus_halo2_tpu_torch.models import verifier_torch  # noqa: E402
from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.serving import ProofBundle, VerificationService  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")


def _read(name):
    with open(os.path.join(ART, f"simple_mul_{name}")) as f:
        return f.read().strip()


@pytest.fixture(scope="module")
def setup():
    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(_read("vk.json")))
    proof = bytes.fromhex(_read("proof.hex"))
    inputs = tuple(parse_public_inputs(_read("public_input.hex")))
    return plan, proof, inputs


def test_bundle_tag_matches_reference_derivation(setup):
    _, proof, inputs = setup
    bundle = ProofBundle(proof, inputs)
    h = hashlib.blake2b(digest_size=32)
    h.update(proof)
    for v in inputs:
        h.update(int(v).to_bytes(32, "big"))
    assert bundle.tag == h.digest() == JProofBundle(proof, inputs).tag
    other = ProofBundle(proof[:-1] + bytes([proof[-1] ^ 1]), inputs)
    assert other.tag != bundle.tag


@pytest.mark.parametrize("rlc_group", [None, 2])
def test_service_accept_reject_and_padding(setup, rlc_group):
    plan, proof, inputs = setup
    svc = VerificationService(plan, batch_size=4, linger_s=0.05, device="cpu", rlc_group=rlc_group)
    try:
        tampered = bytearray(proof)
        tampered[100] ^= 0x40
        bundles = [
            ProofBundle(proof, inputs),
            ProofBundle(bytes(tampered), inputs),
            ProofBundle(proof, inputs),
            ProofBundle(proof, inputs),
            ProofBundle(bytes(tampered), inputs),  # second (partial) batch
        ]
        gated = svc.submit(bundles[0], expected_tag=bundles[1].tag)  # NFT-name gate
        assert gated.done() and gated.result() == (bundles[0].tag, False)
        futures = [svc.submit(b) for b in bundles]
        results = [f.result(timeout=600) for f in futures]
        assert [ok for _, ok in results] == [True, False, True, True, False]
        assert [tag for tag, _ in results] == [b.tag for b in bundles]
        assert svc.verified == 5 and svc.dispatches == 2
    finally:
        svc.close()
    assert not svc._worker.is_alive()


def test_service_propagates_errors(setup):
    plan, proof, inputs = setup
    svc = VerificationService(plan, batch_size=2, linger_s=0.01, device="cpu")
    try:
        with pytest.raises(ValueError, match="proof length"):
            svc.submit(ProofBundle(proof[:-8], inputs)).result(timeout=60)
        with pytest.raises(ValueError, match="public inputs"):
            svc.submit(ProofBundle(proof, inputs[:-1])).result(timeout=60)
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(ProofBundle(proof, inputs))


def test_service_refuses_bad_group_and_missing_gpu(setup, monkeypatch):
    plan, _proof, _inputs = setup
    with pytest.raises(ValueError, match="rlc_group"):
        VerificationService(plan, batch_size=6, device="cpu", rlc_group=4)
    monkeypatch.setattr(verifier_torch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VerificationService(plan, batch_size=4)
