"""The port's exporters (plutus_halo2_tpu_torch/utils/serialization.py),
exactly (byte for byte; there is no tolerance in a serialization):

- export_proof, serialize_proof and export_public_inputs reproduce the
  committed files of every artifact set (the five of examples/artifacts
  and the port's simple_mul GWC19 set), and vk_to_json(vk_from_json(t))
  gives back the committed VK text t;
- each exporter's output equals the JAX package's on the same inputs,
  those sets' and seeded random ones."""

import json
import random

import pytest

from plutus_halo2_tpu.utils import serialization as js
from plutus_halo2_tpu_torch.refimpl.field import Q
from plutus_halo2_tpu_torch.utils import serialization as ts
from plutus_halo2_tpu_torch.utils.artifacts import SETS, read_set

NAMES = list(SETS)


@pytest.mark.parametrize("name", NAMES)
def test_exporters_reproduce_committed_files(name):
    files = read_set(name)
    proof = bytes.fromhex(files["proof.hex"].strip())
    assert ts.export_proof(proof) == files["proof.hex"]
    assert ts.export_proof(bytes.fromhex(files["proof_invalid.hex"])) == files["proof_invalid.hex"]
    if "proof.json" in files:
        assert ts.serialize_proof(proof) == files["proof.json"]
    pis = ts.parse_public_inputs(files["public_input.hex"])
    assert ts.export_public_inputs(pis) == files["public_input.hex"]
    assert ts.vk_to_json(ts.vk_from_json(files["vk.json"])) == files["vk.json"]


@pytest.mark.parametrize("name", NAMES)
def test_exporters_match_jax_on_committed_sets(name):
    files = read_set(name)
    proof = bytes.fromhex(files["proof.hex"].strip())
    assert ts.export_proof(proof) == js.export_proof(proof)
    assert ts.serialize_proof(proof) == js.serialize_proof(proof)
    pis = ts.parse_public_inputs(files["public_input.hex"])
    assert pis == js.parse_public_inputs(files["public_input.hex"])
    assert ts.export_public_inputs(pis) == js.export_public_inputs(pis)
    assert ts.vk_to_json(ts.vk_from_json(files["vk.json"])) == js.vk_to_json(js.vk_from_json(files["vk.json"]))


def test_exporters_match_jax_on_seeded_inputs():
    """Random proof bytes, scalars at and above q (reduced mod q), no
    scalars at all, and a VK whose fields were changed."""
    rng = random.Random(5)
    for n in (0, 1, 48, 1000):
        proof = rng.randbytes(n)
        assert ts.export_proof(proof) == js.export_proof(proof)
        assert ts.serialize_proof(proof) == js.serialize_proof(proof)
        assert json.loads(ts.serialize_proof(proof)) == list(proof)
    for pis in ([], [0], [Q - 1, Q, Q + 5, 2**256 - 1], [rng.randrange(Q) for _ in range(7)]):
        assert ts.export_public_inputs(pis) == js.export_public_inputs(pis)
        assert ts.parse_public_inputs(ts.export_public_inputs(pis)) == [v % Q for v in pis]
    text = read_set("lookup_table")["vk.json"]
    vk, jvk = ts.vk_from_json(text), js.vk_from_json(text)
    repr_ = rng.randrange(Q)
    for v in (vk, jvk):
        v.fixed_commitments.reverse()
        v.omega, v.n, v.transcript_repr = 5, 1 << 20, repr_
    assert ts.vk_to_json(vk) == js.vk_to_json(jvk) != text
