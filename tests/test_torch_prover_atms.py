"""The port's ATMS witness code and prover against the JAX package, on
the CPU: AtmsCircuit.assign's cells, copies and rows equal the JAX
package's at 2 parties (threshold 1) and at 3 of 4, with and without the
lookup column; the 2-party proofs of both circuits, made by the ATMS
example's prove_set (the port's keygen and prove with its defaults, device
"cpu": the plain versions of the Fr polynomial kernels), equal the committed
examples/artifacts/atms*_proof.hex byte for byte, with the committed VK
text; the port's spec verifier accepts them and rejects their tampered
twins."""

import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models import atms as jatms  # noqa: E402
from plutus_halo2_tpu.refimpl.cs import Assignment as JAssignment  # noqa: E402

from plutus_halo2_tpu_torch.examples.atms import prove_set  # noqa: E402
from plutus_halo2_tpu_torch.models import atms  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.cs import Assignment  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.verifier import verify  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set, read_set  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import vk_to_json  # noqa: E402

MSG = 424242
NAMES = ["atms", "atms_with_lookups"]


def _cells(asn, n):
    return ([asn.columns("advice", n), asn.columns("fixed", n)], asn.copies, asn.rows_used)


@pytest.mark.parametrize("lookups", [False, True], ids=["atms", "atms_with_lookups"])
@pytest.mark.parametrize("parties,threshold", [(2, 1), (4, 3)])
def test_assign_equals_the_jax_package(parties, threshold, lookups):
    pks, sigs, comm = atms.prepare_test_signatures(parties, threshold, MSG)
    jpks, jsigs, jcomm = jatms.prepare_test_signatures(parties, threshold, MSG)
    assert (pks, sigs, comm) == (jpks, jsigs, jcomm)
    cls, jcls = ((atms.AtmsLookupCircuit, jatms.AtmsLookupCircuit) if lookups
                 else (atms.AtmsCircuit, jatms.AtmsCircuit))
    c, jc = cls(pks, sigs, MSG, threshold), jcls(jpks, jsigs, MSG, threshold)
    assert c.public_inputs() == jc.public_inputs()
    asn, jasn = Assignment(c.spec), JAssignment(jc.spec)
    c.assign(asn)
    jc.assign(jasn)
    n = 1 << (asn.rows_used - 1).bit_length()
    assert _cells(asn, n) == _cells(jasn, n)


def test_structure_only_construction_still_builds_a_plan():
    """The [None]-signature construction that plan_from_vk takes for every
    party count (utils/artifacts.py)."""
    plan, _proof, _bad, inputs = load_set("atms_228_408")
    assert plan.vk.k == 22 and len(inputs) == 3


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """name -> (plan, proof, inputs): the ATMS example's prove_set at 2
    parties, threshold 1 (its default SRS cached in a temporary working
    directory), each proved once, on first use."""
    made = {}
    work = tmp_path_factory.mktemp("atms_srs")

    def get(name):
        if name not in made:
            with pytest.MonkeyPatch.context() as mp:
                mp.chdir(work)
                m = prove_set(2, 1, name == "atms_with_lookups", device="cpu")
            made[name] = (m["plan"], m["proof"], m["inputs"])
        return made[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_two_party_proof_equals_the_committed_bytes(proofs, name):
    plan, proof, inputs = proofs(name)
    files = read_set(name)
    assert proof.hex() == files["proof.hex"].strip()
    assert vk_to_json(plan.vk) == files["vk.json"]
    assert inputs == load_set(name)[3]


@pytest.mark.parametrize("name", NAMES)
def test_spec_verifier_accepts_the_proof_and_rejects_its_twin(proofs, name):
    plan, proof, inputs = proofs(name)
    _plan, _committed, invalid, _inputs = load_set(name)
    assert verify(plan, proof, inputs)[0]
    assert not verify(plan, invalid, inputs)[0]


@pytest.mark.slow
@pytest.mark.skipif(
    __import__("os").environ.get("PH2_XL_TESTS") != "1",
    reason="a 50-of-90 prove takes ~15 min a set on the host; set PH2_XL_TESTS=1",
)
@pytest.mark.parametrize("name", ["atms_50_90", "atms_with_lookups_50_90"])
def test_50_of_90_sets_equal_the_jax_example(name, tmp_path, monkeypatch):
    """The committed 50-of-90 sets (made by the port's ATMS example) equal
    what the JAX package proves with its example's defaults
    (examples/atms.py --parties 90 --threshold 50 [--lookups]): the
    signatures of prepare_test_signatures(90, 50, 424242), keygen's default
    SRS, prove's default seed; the proof, the tampered twin, the inputs and
    the VK text."""
    from plutus_halo2_tpu.models.layout import build_layout
    from plutus_halo2_tpu.refimpl.keygen import keygen as jkeygen
    from plutus_halo2_tpu.refimpl.prover import prove as jprove
    from plutus_halo2_tpu.utils.serialization import export_public_inputs, vk_to_json as jvk_to_json

    monkeypatch.chdir(tmp_path)  # the default SRS's cache
    pks, sigs, _comm = jatms.prepare_test_signatures(90, 50, MSG)
    cls = jatms.AtmsLookupCircuit if name.startswith("atms_with_lookups") else jatms.AtmsCircuit
    circuit = cls(pks, sigs, MSG, 50)
    pk, plan = jkeygen(circuit)
    proof = jprove(pk, plan, circuit, circuit.public_inputs())
    bad = bytearray(proof)
    bad[min(build_layout(plan).scalar_offsets.values()) + 2] ^= 0x40
    files = read_set(name)
    assert files["proof.hex"] == proof.hex()
    assert files["proof_invalid.hex"] == bytes(bad).hex()
    assert files["public_input.hex"] == export_public_inputs(circuit.public_inputs())
    assert files["vk.json"] == jvk_to_json(plan.vk)
