"""verify_rlc_device + rlc_finalize (the RLC program and its host tail)
against ``JaxVerifier(use_pallas=False)``'s on the same batches, RLC and
subgroup weights and y-hints: an honest batch (no suspect), one with the
tampered twin's row and a row that only the pairing rejects in one group
(suspects within the in-flight re-check width R) and one with such rows in
two groups (more suspects than R, which rlc_finalize re-checks on the host
path). B = 8 in groups of 2 with R patched to 2 on both verifiers, so the
JAX verifier compiles its pairing program at two widths only (its compile
takes minutes on a CPU; in a file of its own, so that it runs beside
test_torch_programs.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from test_torch_rlc import B, _scalar_byte, setup  # noqa: E402,F401  (the RLC tests' fixture)

GROUP, R = 2, 2
# label -> (rows whose point no longer decodes, rows only the pairing rejects)
BATCHES = {"honest": ((), ()), "one group": ((4,), (5,)), "over R": ((), (0, 5))}


def _batch(tv, proof, tampered, scalar):
    proofs = np.stack([proof] * B)
    for r in tampered:
        proofs[r, 100] ^= 0x40
    for r in scalar:
        proofs[r, _scalar_byte(tv, 0)] ^= 0x40
    return proofs


@pytest.fixture(scope="module")
def jax_rlc(setup):
    """{label: (proofs, hints, (verdicts, n_suspects) of the JAX verifier)},
    the RLC weights and the subgroup weights."""
    from plutus_halo2_tpu.models.verifier_jax import JaxVerifier

    _plan, jplan, proof, pis, tv = setup
    jv = JaxVerifier(jplan, use_pallas=False)
    jv._RLC_RECHECK = R
    w = tv.rlc_weights(B, torch.Generator().manual_seed(11))
    sw = tv.subgroup_weights(torch.Generator().manual_seed(12))
    jv.subgroup_weights = lambda rng=None: sw.numpy().astype(np.uint32)
    out = {}
    for label, rows in BATCHES.items():
        proofs = _batch(tv, proof, *rows)
        hints = jv.compute_y_hints(proofs)
        res = jv.verify_rlc_device(proofs, pis.astype(np.uint32), w.numpy().astype(np.uint32), hints,
                                   group=GROUP)
        out[label] = (proofs, hints, (jv.rlc_finalize(*res).tolist(), int(res[1])))
    return out, w, sw


@pytest.mark.parametrize("label", list(BATCHES))
def test_verify_rlc_device_matches_jax_verifier(setup, jax_rlc, label):
    _plan, _jplan, _proof, pis, tv = setup
    out, w, sw = jax_rlc
    proofs, hints, want = out[label]
    assert np.array_equal(tv.compute_y_hints(proofs), hints.astype(np.int64))
    tv._RLC_RECHECK = R
    tv.subgroup_weights = lambda generator=None: sw
    try:
        res = tv.verify_rlc_device(proofs, pis, w, hints.astype(np.int64), group=GROUP)
        got = (tv.rlc_finalize(*res).tolist(), int(res[1]))
    finally:
        del tv._RLC_RECHECK, tv.subgroup_weights
    assert got == want
    bad = set(BATCHES[label][0] + BATCHES[label][1])
    assert got[0] == [i not in bad for i in range(B)]
    assert got[1] == {"honest": 0, "one group": 1, "over R": 4}[label]
