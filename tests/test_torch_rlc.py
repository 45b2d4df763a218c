"""TorchVerifier.verify_rlc on the CPU: its aggregation, suspect gather and
scatter (_agg, _post, _final) limb for limb against JaxVerifier's
_agg_impl, _post_impl and _final_impl on synthetic inputs with a failing
group of fewer suspects than the re-check width (so idle slots exist), and
the whole path at B = 8, group 4, on the committed simple_mul proof as in
test_jax_verifier.py:121-167: per-row verdicts exact with bad rows in two
groups (the host re-check, at a re-check width of 2), with one failing
group (the in-flight re-check with idle slots), and on an honest batch
(no re-check)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models.circuits import SimpleMulCircuit as JSimpleMul  # noqa: E402
from plutus_halo2_tpu.models.verifier_jax import JaxVerifier  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")
B, GROUP = 8, 4


def _read(name):
    with open(os.path.join(ART, f"simple_mul_{name}")) as f:
        return f.read().strip()


@pytest.fixture(scope="module")
def setup():
    vk_text = _read("vk.json")
    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(vk_text))
    jplan = j_plan_from_vk(JSimpleMul(), j_vk_from_json(vk_text))
    proof = np.frombuffer(bytes.fromhex(_read("proof.hex")), np.uint8)
    pis = parse_public_inputs(_read("public_input.hex"))
    tv = TorchVerifier(plan, device="cpu")
    return plan, jplan, proof, tv.encode_public_inputs([pis] * B), tv


def test_agg_post_final_match_jax(setup):
    _plan, jplan, _proof, _pis, tv = setup
    jv = JaxVerifier(jplan, use_pallas=False)
    rng = np.random.default_rng(12)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=2 * B)]
    host[3] = None  # an identity side
    el = np.stack([tc.host_point_to_mont(p) for p in host[:B]])
    er = np.stack([tc.host_point_to_mont(p) for p in host[B:]])
    all_valid = np.ones(B, bool)
    all_valid[1] = False  # an invalid row in the failing group: weight 0, no suspect
    weights = tv.rlc_weights(B, torch.Generator().manual_seed(3))
    assert bool((weights[:, 0] & 1).all()) and not bool(weights[:, 8:].any())

    el_g, er_g = tv._agg(torch.from_numpy(el), torch.from_numpy(er), torch.from_numpy(all_valid),
                         weights, GROUP)
    jel_g, jer_g = jv._agg_impl(el.astype(np.uint32), er.astype(np.uint32), all_valid,
                                weights.numpy().astype(np.uint32), group=GROUP, W=B // GROUP)
    assert np.array_equal(el_g.numpy(), np.asarray(jel_g).astype(np.int64))
    assert np.array_equal(er_g.numpy(), np.asarray(jer_g).astype(np.int64))

    group_ok = np.array([False, True])  # group 0 fails: 3 suspects for R = 8 slots
    R = 8
    out = tv._post(torch.from_numpy(group_ok), torch.from_numpy(all_valid), torch.from_numpy(el),
                   torch.from_numpy(er), GROUP, R)
    verdicts0, n_sus, g_ok, idx, live, el_s, er_s = out
    jv0, jn, jg, jidx_w, jel_s, jer_s = jv._post_impl(group_ok, all_valid, el.astype(np.uint32),
                                                      er.astype(np.uint32), group=GROUP, R=R)
    assert int(n_sus) == int(jn) == 3
    assert verdicts0.tolist() == np.asarray(jv0).tolist()
    assert g_ok.tolist() == np.asarray(jg).tolist()
    assert live.tolist() == [True] * 3 + [False] * 5
    assert idx[live].tolist() == np.asarray(jidx_w)[:3].tolist() == [0, 2, 3]
    assert (np.asarray(jidx_w)[3:] == B).all()
    assert np.array_equal(el_s.numpy(), np.asarray(jel_s).astype(np.int64))
    assert np.array_equal(er_s.numpy(), np.asarray(jer_s).astype(np.int64))

    row_ok = torch.tensor([False, True, False, False, True, True, False, True])
    got = tv._final(verdicts0, idx, live, row_ok)
    want = np.asarray(jv._final_impl(jv0, jidx_w, jnp.asarray(row_ok.numpy())))
    assert got.tolist() == want.tolist() == [False, False, True, False, True, True, True, True]


def _verify_rlc(tv, proofs, pis, recheck=TorchVerifier._RLC_RECHECK):
    """verify_rlc's two legs: (verdicts, number of suspects)."""
    tv._RLC_RECHECK = recheck
    try:
        g = torch.Generator().manual_seed(7)
        out = tv.verify_rlc_device(proofs, pis, tv.rlc_weights(B, g), tv.compute_y_hints(proofs),
                                   group=GROUP, generator=g)
        return tv.rlc_finalize(*out).tolist(), int(out[1])
    finally:
        del tv._RLC_RECHECK


def _scalar_byte(tv, k):
    """A byte inside the k-th proof scalar: its corruption keeps every
    point encoding valid, so only the pairing rejects the row."""
    return list(tv.layout.scalar_offsets.values())[k] + 3


def test_verify_rlc_bad_rows_in_two_groups_host_recheck(setup):
    """Bad rows in both groups: 8 suspects, more than the re-check width of
    2, so rlc_finalize re-checks them on the host path, exactly."""
    _plan, _jplan, proof, pis, tv = setup
    proofs = np.stack([proof] * B)
    proofs[2, _scalar_byte(tv, 0)] ^= 0x40  # corrupt group 0
    proofs[5, _scalar_byte(tv, 1)] ^= 0x11  # corrupt group 1
    proofs[6, _scalar_byte(tv, 2)] ^= 0x22  # second failure in group 1
    verdicts, n_sus = _verify_rlc(tv, proofs, pis, recheck=2)
    assert n_sus == 8
    assert verdicts == [True, True, False, True, True, False, False, True]


def test_verify_rlc_one_failing_group_in_flight(setup):
    """One failing group: 4 suspects for 8 re-check slots; the idle slots
    must not clobber a re-checked row's verdict. A row with an invalid
    encoding is rejected without making its group fail."""
    _plan, _jplan, proof, pis, tv = setup
    proofs = np.stack([proof] * B)
    proofs[1, _scalar_byte(tv, 0)] ^= 0x40
    proofs[6, 100] ^= 0x40  # its third point no longer decodes
    verdicts, n_sus = _verify_rlc(tv, proofs, pis)
    assert n_sus == 4
    assert verdicts == [True, False, True, True, True, True, False, True]


def test_verify_rlc_honest_batch(setup):
    _plan, _jplan, proof, pis, tv = setup
    verdicts, n_sus = _verify_rlc(tv, np.stack([proof] * B), pis)
    assert (verdicts, n_sus) == ([True] * B, 0)
