"""Static transcript/proof layout for a CircuitPlan (host-side).

The reference's generated verifiers walk the proof with a monadic parser
(ApplicativeParser.hs) interleaving reads and squeezes. Because the layout is
fully static per circuit, we flatten it here into:
  - the total transcript byte string template (constant bytes prefilled),
  - scatter indices mapping proof bytes / public-input bytes into it,
  - the ordered squeeze schedule (challenge name -> hashed prefix length),
  - proof offsets of every scalar/point field (for direct parsing).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..refimpl.field import fr_to_le_bytes
from .plan import CircuitPlan


@dataclass
class TranscriptLayout:
    total_len: int
    proof_len: int
    template: np.ndarray  # (total_len,) uint8 constants
    proof_scatter: np.ndarray  # (proof_len,) int32 -> transcript positions
    pi_positions: list  # start offset in transcript per public input (32B each)
    squeezes: list  # ordered (name, msg_len) — msg includes the 0x00 marker
    scalar_offsets: dict  # name -> proof byte offset (32B LE scalar)
    point_offsets: dict  # name -> proof byte offset (48B compressed point)
    challenge_names: list


def build_layout(plan: CircuitPlan) -> TranscriptLayout:
    buf = bytearray()
    proof_scatter: list[int] = []
    pi_positions: list[int] = []
    squeezes: list = []
    scalar_offsets: dict = {}
    point_offsets: dict = {}
    proof_cursor = 0

    def absorb_const(payload: bytes):
        buf.append(0x01)
        buf.extend(payload)

    def absorb_pi():
        buf.append(0x01)
        pi_positions.append(len(buf))
        buf.extend(b"\x00" * 32)

    def read_point(name: str):
        nonlocal proof_cursor
        buf.append(0x01)
        point_offsets[name] = proof_cursor
        for k in range(48):
            proof_scatter.append(len(buf) + k)
        buf.extend(b"\x00" * 48)
        proof_cursor += 48

    def read_scalar(name: str):
        nonlocal proof_cursor
        buf.append(0x01)
        scalar_offsets[name] = proof_cursor
        for k in range(32):
            proof_scatter.append(len(buf) + k)
        buf.extend(b"\x00" * 32)
        proof_cursor += 32

    def squeeze(name: str):
        buf.append(0x00)
        squeezes.append((name, len(buf)))

    absorb_const(fr_to_le_bytes(plan.vk.transcript_repr))
    absorb_const(fr_to_le_bytes(plan.vk.num_public_inputs))
    for _ in range(plan.vk.num_public_inputs):
        absorb_pi()

    for tag, payload in plan.steps:
        if tag == "advice_commitments":
            for i in range(payload):
                read_point(f"advice_{i}")
        elif tag == "theta":
            squeeze("theta")
        elif tag == "lookup_permuted":
            for i in range(payload):
                read_point(f"lookup_perm_input_{i}")
                read_point(f"lookup_perm_table_{i}")
        elif tag == "beta":
            squeeze("beta")
        elif tag == "gamma":
            squeeze("gamma")
        elif tag == "permutation_committed":
            for i in range(payload):
                read_point(f"perm_z_{i}")
        elif tag == "lookup_commitment":
            for i in range(payload):
                read_point(f"lookup_z_{i}")
        elif tag == "vanishing_rand":
            read_point("vanishing_rand")
        elif tag == "y":
            squeeze("y")
        elif tag == "vanishing_split":
            for i in range(payload):
                read_point(f"split_{i}")
        elif tag == "x":
            squeeze("x")
        elif tag == "advice_eval":
            for i in range(payload):
                read_scalar(f"advice_eval_{i}")
        elif tag == "fixed_eval":
            for i in range(payload):
                read_scalar(f"fixed_eval_{i}")
        elif tag == "random_eval":
            read_scalar("random_eval")
        elif tag == "permutation_common":
            for i in range(payload):
                read_scalar(f"perm_common_{i}")
        elif tag == "permutation_eval":
            s, has_last = payload
            read_scalar(f"perm_z_{s}_cur")
            read_scalar(f"perm_z_{s}_next")
            if has_last:
                read_scalar(f"perm_z_{s}_last")
        elif tag == "lookup_eval":
            for i in range(payload):
                read_scalar(f"lookup_{i}_z_cur")
                read_scalar(f"lookup_{i}_z_next")
                read_scalar(f"lookup_{i}_a_cur")
                read_scalar(f"lookup_{i}_a_prev")
                read_scalar(f"lookup_{i}_s_cur")
        elif tag == "x1":
            squeeze("x1")
        elif tag == "x2":
            squeeze("x2")
        elif tag == "f_commitment":
            read_point("f_commitment")
        elif tag == "x3":
            squeeze("x3")
        elif tag == "q_evals":
            for i in range(payload):
                read_scalar(f"q_eval_{i}")
        elif tag == "x4":
            squeeze("x4")
        elif tag == "pi":
            read_point("pi")
        elif tag == "v":
            squeeze("v")
        elif tag == "witnesses":
            for i in range(payload):
                read_point(f"w_{i}")
        elif tag == "u":
            squeeze("u")
        else:
            raise ValueError(tag)

    return TranscriptLayout(
        total_len=len(buf),
        proof_len=proof_cursor,
        template=np.frombuffer(bytes(buf), dtype=np.uint8).copy(),
        proof_scatter=np.asarray(proof_scatter, dtype=np.int32),
        pi_positions=pi_positions,
        squeezes=squeezes,
        scalar_offsets=scalar_offsets,
        point_offsets=point_offsets,
        challenge_names=[name for name, _ in squeezes],
    )
