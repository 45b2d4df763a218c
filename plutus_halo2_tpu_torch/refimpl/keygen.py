"""Verification-only plan building: the port's copy of ``plan_from_vk`` from
``plutus_halo2_tpu/refimpl/keygen.py``. Keygen proper, the prover and the SRS
stay in the JAX package; the port only ever verifies."""

from __future__ import annotations

from ..models.plan import FLAVOR_HALO2, CircuitPlan, VerifyingKeyData
from .cs import CircuitSpec


def plan_from_vk(circuit, vk: VerifyingKeyData,
                 flavor: str = FLAVOR_HALO2) -> CircuitPlan:
    """Verification-only CircuitPlan: circuit STRUCTURE (gates, queries,
    lookups, permutation layout — independent of witness values) + a
    committed VerifyingKeyData (e.g. utils.serialization.vk_from_json).
    Skips the SRS / assignment / commitment work of full keygen. The analog
    of the reference consuming its exported VK constants without re-running
    keygen (code_emitters_plinth.rs:786-888)."""
    spec: CircuitSpec = circuit.spec
    spec.finalize_queries()
    if spec.blinding_factors() != vk.blinding_factors:
        raise ValueError(
            f"circuit structure/blinding mismatch: spec {spec.blinding_factors()}"
            f" != vk {vk.blinding_factors}"
        )
    if circuit.num_public_inputs != vk.num_public_inputs:
        raise ValueError("circuit and vk disagree on the public-input count")
    return CircuitPlan(
        vk=vk,
        flavor=flavor,
        num_advice_columns=spec.num_advice,
        advice_queries=list(spec.advice_queries),
        fixed_queries=list(spec.fixed_queries),
        instance_queries=list(spec.instance_queries),
        gates=list(spec.gates),
        lookups=list(spec.lookups),
        num_permutation_sets=spec.num_permutation_sets(),
        permutation_columns=list(spec.equality_columns),
        chunk_len=spec.chunk_len(),
        num_vanishing_splits=spec.degree() - 1,
        degree=spec.degree(),
    ).finalize()
