"""TorchVerifier (plutus_halo2_tpu_torch/models/verifier_torch.py) on the CPU
(every kernel stage through its plain version) against the refimpl spec
verifier and the JAX verifier, from the committed simple_mul artifacts:
the honest proof is accepted, its committed tampered twin and a bit-flipped
copy are rejected, row by row; the host constants equal JaxVerifier's limb
for limb, and a verifier built from JaxVerifier's constants, in its default
mode, agrees."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.models.verifier_jax import JaxVerifier  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.refimpl.verifier import verify as ref_verify  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import STATE_KEYS, TorchVerifier, host_state  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")


def _read(name):
    with open(os.path.join(ART, f"simple_mul_{name}")) as f:
        return f.read()


@pytest.fixture(scope="module")
def artifacts():
    vk_text = _read("vk.json")
    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(vk_text))
    jplan = j_plan_from_vk(JSimpleMul(), j_vk_from_json(vk_text))
    proof = np.frombuffer(bytes.fromhex(_read("proof.hex").strip()), np.uint8)
    bad = np.frombuffer(bytes.fromhex(_read("proof_invalid.hex").strip()), np.uint8)
    pis = parse_public_inputs(_read("public_input.hex"))
    batch = np.stack([proof, bad, proof]).copy()
    batch[2, 100] ^= 0x40  # bit-flipped row
    return plan, jplan, batch, pis


@pytest.fixture(scope="module")
def own_verdicts(artifacts):
    plan, _jplan, batch, pis = artifacts
    v = TorchVerifier(plan, device="cpu", subgroup_check="off")
    return v.verify(batch, v.encode_public_inputs([pis] * len(batch))).tolist(), v


def test_accepts_honest_rejects_tampered_rowwise(artifacts, own_verdicts):
    _plan, jplan, batch, pis = artifacts
    verdicts, v = own_verdicts
    want = [ref_verify(jplan, bytes(row), pis)[0] for row in batch]
    assert want == [True, False, False]
    assert verdicts == want
    assert v.msm_term_counts == [16]  # the multi-open MSM after dedup


def test_from_jax_state(artifacts, own_verdicts):
    plan, jplan, batch, pis = artifacts
    jv = JaxVerifier(jplan, use_pallas=False)  # the default (aggregate) mode
    state = {k: getattr(jv, k) for k in STATE_KEYS}
    mine = host_state(plan)
    for key in STATE_KEYS:
        a, b = mine[key], state[key]
        if isinstance(b, dict):
            assert set(a) == set(b), key
            for k in b:
                assert np.array_equal(a[k], np.asarray(b[k]).astype(np.int64)), (key, k)
        else:
            assert np.array_equal(a, np.asarray(b).astype(np.int64)), key
    tv = TorchVerifier.from_jax_state(plan, state, device="cpu")
    assert (tv.subgroup_check, tv.subgroup_rounds) == (jv.subgroup_check, jv.subgroup_rounds)
    got = tv.verify(batch, tv.encode_public_inputs([pis] * len(batch)),
                    generator=torch.Generator().manual_seed(1)).tolist()
    assert got == own_verdicts[0]


def test_encode_public_inputs_matches_jax(artifacts):
    plan, jplan, _batch, pis = artifacts
    jv = JaxVerifier(jplan, use_pallas=False, subgroup_check="off")
    tv = TorchVerifier(plan, device="cpu", subgroup_check="off")
    assert np.array_equal(tv.encode_public_inputs([pis, pis]),
                          jv.encode_public_inputs([pis, pis]).astype(np.int64))


@pytest.mark.slow
def test_core_matches_jax_verifier(artifacts):
    """el, er, all_valid and the verdicts limb for limb against the JAX
    verifier's XLA path at B = 2 (its compile takes minutes on a CPU)."""
    plan, jplan, batch, pis = artifacts
    rows = batch[[0, 2]]
    jv = JaxVerifier(jplan, use_pallas=False, subgroup_check="off")
    jpis = jv.encode_public_inputs([pis] * 2)
    jel, jer, jvalid = jv._prog("core", jv._core_impl)(rows, jpis)
    tv = TorchVerifier(plan, device="cpu", subgroup_check="off")
    el, er, valid = tv.core(rows, tv.encode_public_inputs([pis] * 2))
    assert np.array_equal(el.numpy(), np.asarray(jel).astype(np.int64))
    assert np.array_equal(er.numpy(), np.asarray(jer).astype(np.int64))
    assert valid.tolist() == np.asarray(jvalid).tolist()
    assert tv.verify(rows, tv.encode_public_inputs([pis] * 2)).tolist() == \
        np.asarray(jv.verify(rows, jpis)).tolist() == [True, False]


@pytest.mark.slow
def test_core_default_mode_matches_jax_verifier(artifacts):
    """The default mode (y-hints, the aggregate subgroup test) limb for limb
    against the JAX verifier's XLA path, the same hints and weights, with a
    corrupted hint on the second row and the bit-flipped row third (its
    JAX compile takes minutes)."""
    from plutus_halo2_tpu.ops import curve as jc

    plan, jplan, batch, pis = artifacts
    rows = batch[[0, 0, 2, 0]]
    jv = JaxVerifier(jplan, use_pallas=False)
    tv = TorchVerifier(plan, device="cpu")
    hints = jv.compute_y_hints(rows)
    hints[1, 2, 0] ^= 1
    w = jc.subgroup_weights(10, rng=np.random.default_rng(5))
    jpis = jv.encode_public_inputs([pis] * 4)
    jel, jer, jvalid = jv._prog("core", jv._core_impl)(rows, jpis, y_hints=hints, sub_weights=w)
    el, er, valid = tv.core(rows, tv.encode_public_inputs([pis] * 4), hints.astype(np.int64), w)
    assert valid.tolist() == np.asarray(jvalid).tolist() == [True, False, False, True]
    ok = valid.numpy()
    assert np.array_equal(el.numpy()[ok], np.asarray(jel).astype(np.int64)[ok])
    assert np.array_equal(er.numpy()[ok], np.asarray(jer).astype(np.int64)[ok])
