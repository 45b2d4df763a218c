"""TorchVerifier.verify in each subgroup mode, with and without y-hints, on
the CPU against the refimpl spec verifier, at B = 8 from the committed
simple_mul artifacts (test_jax_verifier.py:170-226): honest rows, the
committed tampered proof, a bit-flipped row, a row whose first advice
commitment is swapped for a valid encoding of a point outside G1, and an
honest row with a corrupted y-hint. The swapped row, and the committed
tampered proof, which holds a point outside G1 too, fail the subgroup test
in the aggregate and exact modes (all_valid False) and pass it in off mode;
they reject in every mode through the pairing as well. The corrupted hint
rejects its row on the hinted path only."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu.refimpl.field import P  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.refimpl.verifier import verify as ref_verify  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_pairing  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")
EVIL_ROW, HINT_ROW = 4, 6


def _read(name):
    with open(os.path.join(ART, f"simple_mul_{name}")) as f:
        return f.read().strip()


def _nonsubgroup_point():
    x = 100
    while True:
        rhs = (x**3 + 4) % P
        y = pow(rhs, (P + 1) >> 2, P)
        if y * y % P == rhs and not rc.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


@pytest.fixture(scope="module")
def case():
    vk_text = _read("vk.json")
    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(vk_text))
    jplan = j_plan_from_vk(JSimpleMul(), j_vk_from_json(vk_text))
    good = np.frombuffer(bytes.fromhex(_read("proof.hex")), np.uint8)
    bad = np.frombuffer(bytes.fromhex(_read("proof_invalid.hex")), np.uint8)
    pis = parse_public_inputs(_read("public_input.hex"))
    batch = np.stack([good] * 8).copy()
    batch[1] = bad
    batch[2, 100] ^= 0x40
    batch[EVIL_ROW, 0:48] = np.frombuffer(rc.g1_compress(_nonsubgroup_point()), np.uint8)
    judged = {}
    for row in batch:
        if row.tobytes() not in judged:
            judged[row.tobytes()] = ref_verify(jplan, row.tobytes(), pis)[0]
    ref = [judged[row.tobytes()] for row in batch]
    assert ref == [True, False, False, True, False, True, True, True]
    v = TorchVerifier(plan, device="cpu")
    hints = v.compute_y_hints(batch)
    hints[HINT_ROW, 3, 0] ^= 1
    # rows whose every point decodes (the bit-flipped row does not), and
    # rows whose every point also lies in G1 (the committed tampered proof
    # holds one outside it, as does the swapped row)
    pts, ok = tc.decompress(torch.from_numpy(batch)[:, v._pt_idx])
    decodes = ok.all(-1).tolist()
    assert decodes == [True, True, False, True, True, True, True, True]
    members = (ok & tc.subgroup_check(pts)).all(-1).tolist()
    assert members == [True, False, False, True, False, True, True, True]
    return plan, batch, v.encode_public_inputs([pis] * 8), hints, ref, decodes, members


@pytest.fixture(scope="module")
def hintless(case):
    """core() of the hintless aggregate mode and the pairing of its sides."""
    plan, batch, pis = case[:3]
    v = TorchVerifier(plan, device="cpu")
    el, er, valid = v.core(batch, pis, None, v.subgroup_weights(torch.Generator().manual_seed(2)))
    return el, er, valid, cuda_pairing.pairing_check(el, er, v.pair)


def test_default_mode_with_hints(case, hintless):
    """The default mode's core (the fused decompress-and-subgroup path): the
    same pairing sides as the hintless path except at the corrupted hint's
    row, which it rejects."""
    plan, batch, pis, hints, ref, _decodes, members = case
    el0, er0, _valid0, paired = hintless
    v = TorchVerifier(plan, device="cpu")
    el, er, valid = v.core(batch, pis, hints, v.subgroup_weights(torch.Generator().manual_seed(1)))
    assert valid.tolist() == [m and i != HINT_ROW for i, m in enumerate(members)]
    same = torch.arange(8) != HINT_ROW
    assert torch.equal(el[same], el0[same]) and torch.equal(er[same], er0[same])
    want = list(ref)
    want[HINT_ROW] = False
    assert (paired & valid).tolist() == want


def test_hintless_aggregate_mode(case, hintless):
    ref, _decodes, members = case[4:]
    _el, _er, valid, paired = hintless
    assert valid.tolist() == members
    assert (paired & valid).tolist() == ref


@pytest.mark.parametrize("mode", ["exact", "off"])
def test_exact_and_off_modes(case, hintless, mode):
    """The pairing sides do not depend on the mode; all_valid does, at the
    swapped row only, and the verdicts stay the reference's."""
    plan, batch, pis, _hints, ref, decodes, members = case
    el0, er0, _valid0, paired = hintless
    v = TorchVerifier(plan, device="cpu", subgroup_check=mode)
    el, er, valid = v.core(batch, pis)
    assert torch.equal(el, el0) and torch.equal(er, er0)
    assert valid.tolist() == (decodes if mode == "off" else members)
    assert (paired & valid).tolist() == ref
