"""The GWC19 KZG flavor in the port (TorchVerifier._multiopen_gwc) on the
CPU, every kernel stage through its plain version, against the JAX
package's spec verifier and JAX verifier:

- the committed simple_mul GWC19 artifact set
  (plutus_halo2_tpu_torch/artifacts/simple_mul_gwc19_*) is re-proven here
  with the JAX package's deterministic prover and equals the committed
  files byte for byte;
- the port's query grouping and layout equal the JAX package's;
- verdicts on [honest, committed invalid, bit-flipped] equal the spec's
  row by row in every subgroup mode, with and without y-hints, and the
  two MSMs have K = 3 and 17;
- the pairing sides equal the spec's el and er exactly;
- verify_rlc and the VerificationService on a GWC plan, and a lookup
  circuit's GWC proof made at run time.

Regenerate the committed set with ``python tests/test_torch_gwc.py``."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from plutus_halo2_tpu.models.circuits import LookupRangeCircuit as JLookupRange  # noqa: E402
from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.models.layout import build_layout as j_build_layout  # noqa: E402
from plutus_halo2_tpu.models.plan import FLAVOR_GWC as J_FLAVOR_GWC  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import keygen  # noqa: E402
from plutus_halo2_tpu.refimpl.multiopen import group_queries_by_rotation as j_group  # noqa: E402
from plutus_halo2_tpu.refimpl.prover import prove  # noqa: E402
from plutus_halo2_tpu.refimpl.srs import TrapdoorSRS  # noqa: E402
from plutus_halo2_tpu.refimpl.verifier import verify as ref_verify  # noqa: E402
from plutus_halo2_tpu.utils.serialization import (  # noqa: E402
    export_proof,
    export_public_inputs,
    vk_to_json,
)
from plutus_halo2_tpu_torch.models.circuits import LookupRangeCircuit, SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models.layout import build_layout  # noqa: E402
from plutus_halo2_tpu_torch.models.plan import FLAVOR_GWC  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.multiopen import group_queries_by_rotation  # noqa: E402
from plutus_halo2_tpu_torch.serving import ProofBundle, VerificationService  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

GWC_ART = os.path.join(ROOT, "plutus_halo2_tpu_torch", "artifacts")
EX_ART = os.path.join(ROOT, "examples", "artifacts")
INPUTS = [42, 42, 42]
SRS_SEED = b"test-srs"  # as tests/test_jax_verifier.py proves


def make_gwc_set():
    """Keygen and prove simple_mul (inputs [42, 42, 42]) in the GWC19 flavor
    with the JAX package's refimpl and TrapdoorSRS.from_seed(b"test-srs"):
    (the JAX plan, {file name: text} of the artifact set). The invalid
    twin flips the bit examples/simple_mul.py flips."""
    circuit = JSimpleMul()
    pk, jplan = keygen(circuit, flavor=J_FLAVOR_GWC, srs=TrapdoorSRS.from_seed(SRS_SEED))
    proof = prove(pk, jplan, circuit, INPUTS)
    bad = bytearray(proof)
    bad[48 * 2 + 2] ^= 0x40
    return jplan, {
        "simple_mul_gwc19_vk.json": vk_to_json(jplan.vk),
        "simple_mul_gwc19_proof.hex": export_proof(proof),
        "simple_mul_gwc19_proof_invalid.hex": export_proof(bytes(bad)),
        "simple_mul_gwc19_public_input.hex": export_public_inputs(INPUTS),
    }


def _read(name):
    with open(os.path.join(GWC_ART, f"simple_mul_gwc19_{name}")) as f:
        return f.read()


@pytest.fixture(scope="module")
def gwc():
    jplan, files = make_gwc_set()
    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(_read("vk.json")), flavor=FLAVOR_GWC)
    proof = np.frombuffer(bytes.fromhex(_read("proof.hex").strip()), np.uint8)
    bad = np.frombuffer(bytes.fromhex(_read("proof_invalid.hex").strip()), np.uint8)
    pis = parse_public_inputs(_read("public_input.hex"))
    batch = np.stack([proof, bad, proof]).copy()
    batch[2, 100] ^= 0x40  # bit-flipped row
    spec = [ref_verify(jplan, bytes(row), pis)[0] for row in batch]
    return plan, jplan, files, batch, pis, spec


def test_committed_gwc_set_reproves_byte_for_byte(gwc):
    _plan, _jplan, files, _batch, pis, spec = gwc
    for name, text in files.items():
        with open(os.path.join(GWC_ART, name)) as f:
            assert f.read() == text, name
    assert pis == INPUTS
    assert spec == [True, False, False]


def _plan_from_examples(name, circuit, flavor):
    with open(os.path.join(EX_ART, f"{name}_vk.json")) as f:
        return plan_from_vk(circuit, vk_from_json(f.read()), flavor=flavor)


@pytest.mark.parametrize("name", ["simple_mul_gwc19", "lookup_table"])
def test_group_queries_by_rotation_matches_jax(gwc, name):
    plan = gwc[0] if name == "simple_mul_gwc19" else _plan_from_examples(
        name, LookupRangeCircuit(values=(3, 9, 14), bits=4), FLAVOR_GWC)
    triples = [(q.rot, q.commitment, q.evaluation) for q in plan.all_queries_ordered()]
    got = group_queries_by_rotation(triples)
    assert got == j_group(triples)
    assert [rot for rot, _m in got] == plan.rotation_order
    assert sum(len(m) for _r, m in got) == len(triples)


def test_gwc_layout_matches_the_proven_plan(gwc):
    """The port's layout of the GWC19 plan against the JAX layout of the
    plan the prover used (field by field against the VK-built JAX plan:
    tests/test_torch_circuits.py)."""
    plan, jplan, _files, batch, _pis, _spec = gwc
    lay, jlay = build_layout(plan), j_build_layout(jplan)
    assert (lay.squeezes, lay.point_offsets, lay.scalar_offsets) == (jlay.squeezes, jlay.point_offsets,
                                                                     jlay.scalar_offsets)
    assert lay.proof_len == batch.shape[1] == 1072 and len(lay.point_offsets) == 11
    assert [n for n, _l in lay.squeezes] == ["theta", "beta", "gamma", "y", "x", "v", "u"]


@pytest.mark.parametrize("mode,hinted", [("off", False), ("exact", False), ("aggregate", False),
                                         ("aggregate", True)])
def test_gwc_verdicts_match_spec(gwc, mode, hinted):
    plan, _jplan, _files, batch, pis, spec = gwc
    v = TorchVerifier(plan, device="cpu", subgroup_check=mode)
    hints = v.compute_y_hints(batch) if hinted else None
    got = v.verify(batch, v.encode_public_inputs([pis] * len(batch)), hints,
                   torch.Generator().manual_seed(3))
    assert got.tolist() == spec
    assert v.msm_term_counts == [3, 17]  # the left and the right MSM after dedup


def test_gwc_pairing_sides_equal_spec(gwc):
    """el and -er of the honest row equal the spec's traces["el"] and
    traces["er"] after affine normalisation."""
    plan, jplan, _files, batch, pis, _spec = gwc
    ok, traces = ref_verify(jplan, bytes(batch[0]), pis, collect_traces=True)
    assert ok
    v = TorchVerifier(plan, device="cpu", subgroup_check="off")
    el, er, valid = v.core(batch[:1], v.encode_public_inputs([pis]))
    assert valid.tolist() == [True]
    assert tc.host_point_from_mont(el[0].numpy()) == traces["el"]
    assert tc.host_point_from_mont(tc.neg(er)[0].numpy()) == traces["er"]


def test_gwc_verify_rlc(gwc):
    """As test_jax_verifier.py's test_verify_rlc_gwc_flavor: B = 4, group 2,
    a bit-flipped third row; el is an MSM output here, not a proof point."""
    plan, _jplan, _files, batch, pis, _spec = gwc
    proofs = np.stack([batch[0]] * 4)
    proofs[2, 100] ^= 0x40
    v = TorchVerifier(plan, device="cpu")
    out = v.verify_rlc(proofs, v.encode_public_inputs([pis] * 4), v.compute_y_hints(proofs),
                       group=2, generator=torch.Generator().manual_seed(9))
    assert out.tolist() == [True, True, False, True]
    assert v.msm_term_counts == [3, 17, 2]


def test_lookup_table_gwc_proven_at_run_time():
    """A lookup circuit in the GWC19 flavor: proven here by the JAX
    package's refimpl, its plan rebuilt by the port from the exported VK."""
    circuit = JLookupRange(values=(3, 9, 14), bits=4)
    pk, jplan = keygen(circuit, flavor=J_FLAVOR_GWC, srs=TrapdoorSRS.from_seed(SRS_SEED))
    inputs = [7]
    proof = np.frombuffer(prove(pk, jplan, circuit, inputs), np.uint8)
    bad = proof.copy()
    bad[48 * 2 + 2] ^= 0x40
    plan = plan_from_vk(LookupRangeCircuit(values=(3, 9, 14), bits=4),
                        vk_from_json(vk_to_json(jplan.vk)), flavor=FLAVOR_GWC)
    v = TorchVerifier(plan, device="cpu")
    batch = np.stack([proof, bad])
    got = v.verify(batch, v.encode_public_inputs([inputs] * 2), v.compute_y_hints(batch),
                   torch.Generator().manual_seed(4))
    assert got.tolist() == [ref_verify(jplan, bytes(r), inputs)[0] for r in batch] == [True, False]
    assert v.msm_term_counts[0] == len(plan.rotation_order) and len(v.msm_term_counts) == 2


def test_gwc_service_round_trip(gwc):
    plan, _jplan, _files, batch, pis, spec = gwc
    svc = VerificationService(plan, batch_size=4, linger_s=0.05, device="cpu", rlc_group=2)
    try:
        futs = [svc.submit(ProofBundle(bytes(row), tuple(pis))) for row in batch]
        got = [f.result(timeout=600)[1] for f in futs]
    finally:
        svc.close()
    assert got == spec
    assert svc.dispatches == 1


@pytest.mark.slow
def test_gwc_core_matches_jax_verifier(gwc):
    """el, er, all_valid limb for limb against the JAX verifier's XLA path
    on the GWC plan at B = 2 (its compile takes minutes on a CPU)."""
    from plutus_halo2_tpu.models.verifier_jax import JaxVerifier

    plan, jplan, _files, batch, pis, _spec = gwc
    rows = batch[[0, 2]]
    jv = JaxVerifier(jplan, use_pallas=False, subgroup_check="off")
    jpis = jv.encode_public_inputs([pis] * 2)
    jel, jer, jvalid = jv._prog("core", jv._core_impl)(rows, jpis)
    tv = TorchVerifier(plan, device="cpu", subgroup_check="off")
    el, er, valid = tv.core(rows, tv.encode_public_inputs([pis] * 2))
    assert np.array_equal(el.numpy(), np.asarray(jel).astype(np.int64))
    assert np.array_equal(er.numpy(), np.asarray(jer).astype(np.int64))
    assert valid.tolist() == np.asarray(jvalid).tolist()
    assert jv.msm_term_counts == tv.msm_term_counts == [3, 17]


if __name__ == "__main__":
    os.makedirs(GWC_ART, exist_ok=True)
    for fname, body in make_gwc_set()[1].items():
        with open(os.path.join(GWC_ART, fname), "w") as f:
            f.write(body)
        print(os.path.join("plutus_halo2_tpu_torch", "artifacts", fname))
