"""The one generator of the benchmark's traffic: a configuration's committed
set and a mix's parameters (``traffic/<name>.json``) in, the batches a run
cycles through out, all from ``--seed``.

A mix's parameters:

- ``entry``: the port's entry point (``entries/<entry>.py``); ``batch``,
  proofs a call; ``in_flight``, calls issued before the oldest one's
  verdicts are read (a closed loop);
- ``hints``: ``"submitter"`` (y-hints travel with the proofs, made here in
  set-up, as a submitter makes them) or ``"none"`` (the port decodes on the
  device); ``subgroup``, ``subgroup_rounds``: the port's subgroup mode;
  ``rlc_group``: proofs a pairing for the RLC entry;
- ``invalid_per_batch`` rows of every batch are invalid, at seeded rows;
  their kinds cycle over ``invalid_kinds`` in a fixed order, so every seed
  makes the same mix of kinds, and each kind has ``variants_per_kind``
  seeded variants (the committed invalid twin has one);
- ``layouts``: distinct batches a seed makes, which the window cycles
  through; ``trace_batches``: batches in a traced sub-window.

Kinds: ``invalid_twin`` (the set's committed invalid proof),
``point_bit`` (a bit flipped anywhere in a proof point's 48-byte
encoding), ``scalar_bit`` (a bit flipped in a proof scalar),
``noncanonical_scalar`` (a proof scalar s written as s + q, which the
transcript absorbs as written). Honest rows are the committed proof.

RLC weights come from the seed; the subgroup test's weights are drawn in
each call from a ``torch.Generator`` seeded from it."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference.artifacts import parse_public_inputs, plan_from_spec, proof_items, vk_from_json
from .reference.field import P, Q

FP_LIMBS, FR_LIMBS = 25, 17  # the port's 16-bit limbs of an Fp and an Fr value
KINDS = ("invalid_twin", "point_bit", "scalar_bit", "noncanonical_scalar")


def limbs16(x: int, n: int) -> list[int]:
    return [(x >> (16 * i)) & 0xFFFF for i in range(n)]


def y_hints(proof: bytes, point_offsets) -> np.ndarray:
    """(n_points, 25) int64: a candidate sqrt(x^3 + 4) of each compressed
    proof point, in canonical 16-bit limbs (the port's y-hint format). A
    submitter's arithmetic: the port re-checks every hint."""
    e = (P + 1) >> 2
    out = np.zeros((len(point_offsets), FP_LIMBS), np.int64)
    for i, off in enumerate(point_offsets):
        x = int.from_bytes(bytes([proof[off] & 0x1F]) + proof[off + 1: off + 48], "big") % P
        out[i] = limbs16(pow((x * x % P * x + 4) % P, e, P), FP_LIMBS)
    return out


def seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % (1 << 64))


@dataclass
class Layout:
    """One batch: rows[i] indexes the distinct inputs; proofs (B, PLEN)
    uint8; hints (B, n_points, 25) int64 or None; rlc_weights (B, 17) int64
    or None."""

    rows: np.ndarray
    proofs: np.ndarray
    hints: np.ndarray | None
    rlc_weights: np.ndarray | None


@dataclass
class Traffic:
    plan: object                 # the reference's plan of the configuration
    public_inputs: list[int]
    pis: np.ndarray              # (B, n_pi, 17) int64: every row's public inputs
    distinct: list[bytes]        # 0: the honest proof; then the invalid variants
    kinds: list[str]             # "honest" or the kind of each distinct input
    layouts: list[Layout]
    vk_json: str                 # the committed VK, which the port's set-up reads


def read_set(prefix) -> dict:
    """{suffix: text} of a configuration's committed set."""
    return {s: (prefix.parent / f"{prefix.name}_{s}").read_text()
            for s in ("proof.hex", "proof_invalid.hex", "public_input.hex", "vk.json")}


def _variant(kind: str, honest: bytes, twin: bytes, items, rng) -> bytes:
    if kind == "invalid_twin":
        return twin
    b = bytearray(honest)
    want = "point" if kind == "point_bit" else "scalar"
    offs = [off for off, k in items if k == want]
    off = offs[int(rng.integers(len(offs)))]
    if kind == "noncanonical_scalar":
        s = int.from_bytes(honest[off: off + 32], "little") + Q
        b[off: off + 32] = s.to_bytes(32, "little")  # s < q, so s + q < 2^256
    else:
        bit = int(rng.integers(8 * (48 if want == "point" else 32)))
        b[off + bit // 8] ^= 1 << (bit % 8)
    return bytes(b)


def generate(config: dict, circuit, traffic: dict, seed: int, artifacts) -> Traffic:
    """Every input of a run of (config, traffic) from the seed."""
    files = read_set(artifacts)
    pis = parse_public_inputs(files["public_input.hex"])
    plan = plan_from_spec(circuit.spec(), vk_from_json(files["vk.json"]), config["flavor"],
                          circuit.NUM_PUBLIC_INPUTS)
    honest = bytes.fromhex(files["proof.hex"].strip())
    twin = bytes.fromhex(files["proof_invalid.hex"].strip())
    items = proof_items(plan)
    if items[-1][0] + (48 if items[-1][1] == "point" else 32) != len(honest):
        raise ValueError("the plan's proof walk does not cover the committed proof")
    rng = seed_rng(seed)

    kinds = list(traffic["invalid_kinds"])
    unknown = set(kinds) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown invalid kinds {sorted(unknown)}")
    distinct, labels = [honest], ["honest"]
    by_kind: dict[str, list[int]] = {}
    for kind in kinds:
        n = 1 if kind == "invalid_twin" else int(traffic["variants_per_kind"])
        by_kind[kind] = []
        while len(by_kind[kind]) < n:
            v = _variant(kind, honest, twin, items, rng)
            if v in distinct:
                continue  # a flip that repeats an input: draw again
            by_kind[kind].append(len(distinct))
            distinct.append(v)
            labels.append(kind)

    B = int(traffic["batch"])
    n_inv = int(traffic["invalid_per_batch"])
    point_offsets = [off for off, k in items if k == "point"]
    hints = np.stack([y_hints(p, point_offsets) for p in distinct]) if traffic["hints"] == "submitter" else None
    rows_all = np.frombuffer(b"".join(distinct), np.uint8).reshape(len(distinct), -1)
    layouts = []
    for li in range(int(traffic["layouts"])):
        rows = np.zeros(B, np.int64)
        for j, pos in enumerate(rng.choice(B, n_inv, replace=False)):
            choices = by_kind[kinds[(li * n_inv + j) % len(kinds)]]
            rows[pos] = choices[int(rng.integers(len(choices)))]
        weights = None
        if traffic["entry"] == "verify_rlc_device":
            weights = np.zeros((B, FR_LIMBS), np.int64)
            weights[:, :8] = rng.integers(0, 1 << 16, (B, 8))
            weights[:, 0] |= 1  # nonzero 128-bit weights
        layouts.append(Layout(rows, np.ascontiguousarray(rows_all[rows]),
                              None if hints is None else np.ascontiguousarray(hints[rows]), weights))
    pi_limbs = np.array([limbs16(v % Q, FR_LIMBS) for v in pis], np.int64)
    return Traffic(plan, pis, np.ascontiguousarray(np.broadcast_to(pi_limbs, (B, *pi_limbs.shape))),
                   distinct, labels, layouts, files["vk.json"])
