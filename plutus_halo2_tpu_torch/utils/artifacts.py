"""The committed artifact sets the port verifies: simple_mul, lookup_table,
atms, atms_with_lookups and atms_228_408 (halo2-book KZG, the JAX
package's ``examples/artifacts/``), simple_mul's GWC19 set, the ATMS
pair at 90 parties and threshold 50, and the lookup variant of that pair
in the GWC19 flavor (the port's own, ``plutus_halo2_tpu_torch/artifacts/``;
the last three made on the card by ``python3 -m
plutus_halo2_tpu_torch.examples.atms [gwc_kzg] --parties 90 --threshold 50
[--lookups]``). Each set is a proof, its
invalid twin, the public inputs and the VK, as the reference's
proof_serialization.rs writes them (``utils/serialization.py``); the plan
is rebuilt from the VK and the circuit's structure (``plan_from_vk``), so
nothing is proven here."""

from __future__ import annotations

from pathlib import Path

from ..models.atms import AtmsCircuit, AtmsLookupCircuit
from ..models.circuits import LookupRangeCircuit, SimpleMulCircuit
from ..models.plan import FLAVOR_GWC, FLAVOR_HALO2
from ..refimpl.keygen import plan_from_vk
from .serialization import parse_public_inputs, vk_from_json

EXAMPLES = Path(__file__).resolve().parents[2] / "examples" / "artifacts"
PORT = Path(__file__).resolve().parents[1] / "artifacts"

# the circuits' structure only: one ATMS construction serves every party count
_ATMS_ARGS = ([(0, 1)] * 2, [None] * 2, 0, 1)

SETS = {  # name -> (directory, circuit factory, flavor)
    "simple_mul": (EXAMPLES, SimpleMulCircuit, FLAVOR_HALO2),
    "simple_mul_gwc19": (PORT, SimpleMulCircuit, FLAVOR_GWC),
    "lookup_table": (EXAMPLES, lambda: LookupRangeCircuit(values=(3, 9, 14), bits=4), FLAVOR_HALO2),
    "atms": (EXAMPLES, lambda: AtmsCircuit(*_ATMS_ARGS), FLAVOR_HALO2),
    "atms_with_lookups": (EXAMPLES, lambda: AtmsLookupCircuit(*_ATMS_ARGS), FLAVOR_HALO2),
    "atms_228_408": (EXAMPLES, lambda: AtmsCircuit(*_ATMS_ARGS), FLAVOR_HALO2),
    "atms_50_90": (PORT, lambda: AtmsCircuit(*_ATMS_ARGS), FLAVOR_HALO2),
    "atms_with_lookups_50_90": (PORT, lambda: AtmsLookupCircuit(*_ATMS_ARGS), FLAVOR_HALO2),
    "atms_with_lookups_50_90_gwc19": (PORT, lambda: AtmsLookupCircuit(*_ATMS_ARGS), FLAVOR_GWC),
}

# the files of a set, by suffix; proof.json (serialize_proof) where committed
FILES = ("proof.hex", "proof_invalid.hex", "public_input.hex", "vk.json", "proof.json")


def read_set(name: str) -> dict:
    """{suffix: text} of the set's committed files."""
    directory = SETS[name][0]
    out = {}
    for suffix in FILES:
        path = directory / f"{name}_{suffix}"
        if path.exists():
            out[suffix] = path.read_text()
    return out


def has_set(name: str) -> bool:
    """Whether the set's proof, invalid twin, public inputs and VK are committed."""
    directory = SETS[name][0]
    return all((directory / f"{name}_{suffix}").exists() for suffix in FILES[:4])


def load_set(name: str):
    """(plan, honest proof bytes, invalid twin bytes, public inputs) of a set."""
    _directory, circuit, flavor = SETS[name]
    files = read_set(name)
    return (plan_from_vk(circuit(), vk_from_json(files["vk.json"]), flavor=flavor),
            bytes.fromhex(files["proof.hex"].strip()), bytes.fromhex(files["proof_invalid.hex"].strip()),
            parse_public_inputs(files["public_input.hex"]))
