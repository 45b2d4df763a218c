"""A configuration's committed set as the reference reads it: the VK's JSON
and the public inputs' hex (the formats of the reference's
proof_serialization.rs), and the verification plan rebuilt from the
circuit's structure and the VK (the frozen counterpart of the port's
``utils/serialization.py`` and ``refimpl/keygen.plan_from_vk``)."""

from __future__ import annotations

import json

from .cs import CircuitSpec
from .curve import g1_decompress, g2_decompress
from .plan import CircuitPlan, VerifyingKeyData


def vk_from_json(text: str) -> VerifyingKeyData:
    d = json.loads(text)
    return VerifyingKeyData(
        fixed_commitments=[g1_decompress(bytes.fromhex(h)) for h in d["fixed_commitments"]],
        permutation_commitments=[g1_decompress(bytes.fromhex(h)) for h in d["permutation_commitments"]],
        omega=int(d["omega"], 16),
        omega_inv=int(d["omega_inv"], 16),
        barycentric_weight=int(d["barycentric_weight"], 16),
        n=d["n"],
        k=d["k"],
        blinding_factors=d["blinding_factors"],
        transcript_repr=int(d["transcript_repr"], 16),
        s_g2=g2_decompress(bytes.fromhex(d["s_g2"])),
        num_public_inputs=d["num_public_inputs"],
    )


def parse_public_inputs(text: str) -> list[int]:
    """Per-line big-endian hex scalars (proof_serialization.rs:36-46)."""
    return [int(line, 16) for line in text.strip().splitlines() if line.strip()]


def plan_from_spec(spec: CircuitSpec, vk: VerifyingKeyData, flavor: str, num_public_inputs: int) -> CircuitPlan:
    """The verification plan of a circuit's structure under a committed VK."""
    spec.finalize_queries()
    if spec.blinding_factors() != vk.blinding_factors:
        raise ValueError(f"circuit structure/blinding mismatch: spec {spec.blinding_factors()} "
                         f"!= vk {vk.blinding_factors}")
    if num_public_inputs != vk.num_public_inputs:
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


def proof_items(plan: CircuitPlan) -> list[tuple[int, str]]:
    """(byte offset, "point" | "scalar") of every item the proof walk reads,
    in order (48-byte compressed points, 32-byte little-endian scalars)."""
    sizes = {"advice_commitments": ("point", 1), "lookup_permuted": ("point", 2),
             "permutation_committed": ("point", 1), "lookup_commitment": ("point", 1),
             "vanishing_rand": ("point", 1), "vanishing_split": ("point", 1), "advice_eval": ("scalar", 1),
             "fixed_eval": ("scalar", 1), "random_eval": ("scalar", 1), "permutation_common": ("scalar", 1),
             "lookup_eval": ("scalar", 5), "f_commitment": ("point", 1), "q_evals": ("scalar", 1),
             "pi": ("point", 1), "witnesses": ("point", 1)}
    items, off = [], 0
    for tag, payload in plan.steps:
        if tag == "permutation_eval":
            kind, n = "scalar", 3 if payload[1] else 2
        elif tag in sizes:
            kind, per = sizes[tag]
            n = per * payload
        else:
            continue  # a challenge
        for _ in range(n):
            items.append((off, kind))
            off += 48 if kind == "point" else 32
    return items
