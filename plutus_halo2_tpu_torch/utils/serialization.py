"""Verifying-key and public-input parsing: the port's copy of ``vk_from_json``
and ``parse_public_inputs`` from ``plutus_halo2_tpu/utils/serialization.py``
(the formats of the reference's proof_serialization.rs and VK constants,
code_emitters_plinth.rs:786-888)."""

from __future__ import annotations

import json

from ..models.plan import VerifyingKeyData
from ..refimpl.curve import g1_decompress, g2_decompress


def parse_public_inputs(text: str) -> list[int]:
    """Per-line big-endian hex scalars (proof_serialization.rs:36-46)."""
    return [int(line, 16) for line in text.strip().splitlines() if line.strip()]


def vk_from_json(text: str) -> VerifyingKeyData:
    d = json.loads(text)
    return VerifyingKeyData(
        fixed_commitments=[g1_decompress(bytes.fromhex(h)) for h in d["fixed_commitments"]],
        permutation_commitments=[
            g1_decompress(bytes.fromhex(h)) for h in d["permutation_commitments"]
        ],
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
