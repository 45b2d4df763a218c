"""The port's example scripts (plutus_halo2_tpu_torch/examples/), run with
--cpu --out <tmp> from a temporary working directory (their SRS cache,
kzg_params/, lands there): simple_mul, lookup_table and equations_test
write files equal to the committed examples/artifacts/ ones byte for byte,
and simple_mul's GWC19 flavor the bytes the JAX package's keygen and prove
give with the same defaults; each example's asserts (the spec verifier's
verdicts, TorchVerifier's [True, False]) hold. The ATMS example's
prove_set at 2 parties runs in tests/test_torch_prover_atms.py."""

import os

import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.models.plan import FLAVOR_GWC as J_GWC  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import keygen as jkeygen  # noqa: E402
from plutus_halo2_tpu.refimpl.prover import prove as jprove  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_to_json as jvk_to_json  # noqa: E402

from plutus_halo2_tpu_torch.examples import equations_test, lookup_table, simple_mul  # noqa: E402
from plutus_halo2_tpu_torch.examples._common import OUT  # noqa: E402

EX_ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")

FILES = {
    "simple_mul": ["simple_mul_proof.hex", "simple_mul_proof.json", "simple_mul_proof_invalid.hex",
                   "simple_mul_public_input.hex", "simple_mul_vk.json"],
    "lookup_table": ["lookup_table_proof.hex", "lookup_table_proof_invalid.hex", "lookup_table_public_input.hex",
                     "lookup_table_vk.json"],
    "equations_test": ["gates_test_vectors.json"],
}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _committed(name):
    with open(os.path.join(EX_ART, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", list(FILES))
def test_example_writes_the_committed_files(workdir, name):
    example = {"simple_mul": simple_mul, "lookup_table": lookup_table, "equations_test": equations_test}[name]
    out = workdir / "out"
    example.main(["--cpu", "--out", str(out)])
    assert sorted(os.listdir(out)) == sorted(FILES[name])
    for f in FILES[name]:
        assert (out / f).read_text() == _committed(f), f


def test_simple_mul_gwc_example_equals_the_jax_package(workdir, capsys):
    out = workdir / "out"
    simple_mul.main(["gwc_kzg", "--cpu", "--out", str(out)])
    assert "flavor: gwc19" in capsys.readouterr().out
    circuit = JSimpleMul(7, 2, 3, 7 * 4 * 9)
    pk, plan = jkeygen(circuit, flavor=J_GWC)  # the default SRS: kzg_params/ in the working directory
    proof = jprove(pk, plan, circuit, [42, 42, 42])
    assert (out / "simple_mul_proof.hex").read_text() == proof.hex()
    assert (out / "simple_mul_vk.json").read_text() == jvk_to_json(plan.vk)


def test_examples_default_to_the_card_and_to_chiprun_out(workdir, monkeypatch):
    """Without --cpu an example asks for the card and raises where there is
    none; its default output directory is chiprun_out/examples/ of the
    repository, never examples/artifacts/."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simple_mul.main(["--out", str(workdir / "out")])
    assert OUT.parts[-2:] == ("chiprun_out", "examples")
    assert not (workdir / "out").exists()
