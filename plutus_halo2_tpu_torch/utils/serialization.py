"""Proof, public-input and verifying-key serialization: the port's copy of
``plutus_halo2_tpu/utils/serialization.py``.

Mirrors the reference's proof_serialization.rs: ``export_proof`` (hex
string), ``serialize_proof`` (JSON byte array), ``export_public_inputs``
(per-line big-endian hex; the Rust side reverses LE bytes, :38-39), and
their parsers. The VK export has the shape of the generated VKConstants
modules (code_emitters_plinth.rs:786-888), so plans round-trip through
JSON."""

from __future__ import annotations

import json

from ..models.plan import VerifyingKeyData
from ..refimpl.curve import g1_compress, g1_decompress, g2_compress, g2_decompress
from ..refimpl.field import Q


def export_proof(proof: bytes) -> str:
    """Hex string (proof_serialization.rs:6-19)."""
    return proof.hex()


def serialize_proof(proof: bytes) -> str:
    """JSON array of byte values (proof_serialization.rs:21-34)."""
    return json.dumps(list(proof))


def export_public_inputs(instances) -> str:
    """Per-line big-endian hex of each scalar (proof_serialization.rs:36-46)."""
    lines = []
    for v in instances:
        lines.append((v % Q).to_bytes(32, "big").hex())
    return "\n".join(lines) + "\n"


def parse_public_inputs(text: str) -> list[int]:
    """Per-line big-endian hex scalars (proof_serialization.rs:36-46)."""
    return [int(line, 16) for line in text.strip().splitlines() if line.strip()]


def vk_to_json(vk: VerifyingKeyData) -> str:
    """Verifying-key constants, compressed points (vk_constants templates)."""
    return json.dumps(
        {
            "fixed_commitments": [g1_compress(p).hex() for p in vk.fixed_commitments],
            "permutation_commitments": [
                g1_compress(p).hex() for p in vk.permutation_commitments
            ],
            "omega": hex(vk.omega),
            "omega_inv": hex(vk.omega_inv),
            "barycentric_weight": hex(vk.barycentric_weight),
            "n": vk.n,
            "k": vk.k,
            "blinding_factors": vk.blinding_factors,
            "transcript_repr": hex(vk.transcript_repr),
            "s_g2": g2_compress(vk.s_g2).hex(),
            "num_public_inputs": vk.num_public_inputs,
        },
        indent=2,
    )


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
