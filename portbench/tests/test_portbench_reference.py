"""The benchmark's plain reference: it accepts each configuration's
committed proof and rejects its invalid twin, agrees with the port's spec
verifier on every kind of invalid variant, and its flat MSM evaluates to
the spec verifier's pairing sides."""

import pytest

from portbench import spec, traffic
from portbench.reference import verifier as ref

CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]
CELL = {c: next(w["name"] for w in spec.benchmark()["workloads"] if w["config"] == c) for c in CONFIGS}


def _inputs(config, seed=11):
    cell = spec.cell(CELL[config], False)
    cell.traffic.update(batch=16, layouts=1, invalid_per_batch=1)
    return cell, traffic.generate(cell.config, cell.circuit(), cell.traffic, seed, cell.artifacts)


@pytest.mark.parametrize("config", CONFIGS)
def test_accepts_the_proof_and_rejects_the_twin(config):
    cell, g = _inputs(config)
    honest = ref.verify(g.plan, g.distinct[0], g.public_inputs)
    assert honest.accepted and honest.stage == ref.ACCEPTED
    assert 0 < len(honest.msms[0]) <= cell.config["msm_terms"]
    twin = ref.verify(g.plan, g.distinct[g.kinds.index("invalid_twin")], g.public_inputs)
    assert not twin.accepted


@pytest.mark.parametrize("config", CONFIGS)
def test_agrees_with_the_port_spec_verifier(config):
    from plutus_halo2_tpu_torch.refimpl.verifier import verify as port_spec
    from plutus_halo2_tpu_torch.utils.artifacts import load_set

    _cell, g = _inputs(config)
    plan = load_set(spec.cell(CELL[config], False).config["port_set"])[0]
    for proof, kind in zip(g.distinct, g.kinds):
        mine = ref.verify(g.plan, proof, g.public_inputs)
        theirs, traces = port_spec(plan, proof, g.public_inputs, collect_traces=True)
        assert mine.accepted == theirs, kind
        if mine.stage != ref.DECODE:
            assert (mine.el, mine.er) == (traces["el"], traces["er"]), kind


def test_merge_terms():
    from portbench.reference.curve import G1_GEN, g1_msm

    p2 = g1_msm([2], [G1_GEN])
    terms = [(3, G1_GEN), (5, p2), (traffic.Q - 3, G1_GEN), (4, None), (0, p2)]
    assert ref.merge_terms(terms) == [(5, p2)]
