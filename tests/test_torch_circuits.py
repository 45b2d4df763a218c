"""The lookup and ATMS circuits in the port on the CPU, every kernel stage
through its plain version, from the committed artifact sets of
examples/artifacts (as tests/test_artifacts.py replays them with the spec
verifier), and the port's simple_mul GWC19 set:

- the port's plans (plutus_halo2_tpu_torch/models/{circuits,atms}.py
  through its plan_from_vk) equal the JAX package's field by field, and
  so do their transcript layouts;
- TorchVerifier's verdicts in the default mode (y-hints, the aggregate
  subgroup test) on [honest, committed invalid, bit-flipped] equal the
  spec verifier's row by row, with the multi-open MSM at K = 19, 32, 36
  and 32;
- chip_smoke's mixed-batch construction gives, row by row, the spec
  verifier's verdicts on every circuit set chip_smoke drives."""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from plutus_halo2_tpu.models import atms as j_atms  # noqa: E402
from plutus_halo2_tpu.models import circuits as j_circuits  # noqa: E402
from plutus_halo2_tpu.models.layout import build_layout as j_build_layout  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.refimpl.verifier import verify as ref_verify  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models import atms, circuits  # noqa: E402
from plutus_halo2_tpu_torch.models.layout import build_layout  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json  # noqa: E402

EX_ART = os.path.join(ROOT, "examples", "artifacts")
GWC_ART = os.path.join(ROOT, "plutus_halo2_tpu_torch", "artifacts")

# name -> (directory, circuit class name, constructor arguments, flavor,
# the multi-open MSMs' K); one ATMS construction serves every party count
# (tests/test_artifacts.py)
ATMS_ARGS = ([(0, 1)] * 2, [None] * 2, 0, 1)
SETS = {
    "lookup_table": (EX_ART, "LookupRangeCircuit", dict(values=(3, 9, 14), bits=4), "halo2", [19]),
    "atms": (EX_ART, "AtmsCircuit", ATMS_ARGS, "halo2", [32]),
    "atms_with_lookups": (EX_ART, "AtmsLookupCircuit", ATMS_ARGS, "halo2", [36]),
    "atms_228_408": (EX_ART, "AtmsCircuit", ATMS_ARGS, "halo2", [32]),
    "simple_mul_gwc19": (GWC_ART, "SimpleMulCircuit", {}, "gwc19", [3, 17]),
}
CIRCUITS = ["lookup_table", "atms", "atms_with_lookups", "atms_228_408"]
# the JAX package's own construction of the 408-party set
# (tests/test_artifacts.py), held against the port's 2-party one
J_ARGS = {"atms_228_408": ([(0, 1)] * 408, [None] * 408, 0, 228)}


def _circuit(modules, cls, args):
    mod = next(m for m in modules if hasattr(m, cls))
    return getattr(mod, cls)(**args) if isinstance(args, dict) else getattr(mod, cls)(*args)


@functools.lru_cache(maxsize=None)
def _load(name):
    """(port plan, JAX plan, honest proof, invalid twin, public inputs)."""
    art, cls, args, flavor, _k = SETS[name]

    def read(suffix):
        with open(os.path.join(art, f"{name}_{suffix}")) as f:
            return f.read()

    vk_text = read("vk.json")
    plan = plan_from_vk(_circuit((circuits, atms), cls, args), vk_from_json(vk_text), flavor=flavor)
    jplan = j_plan_from_vk(_circuit((j_circuits, j_atms), cls, J_ARGS.get(name, args)), j_vk_from_json(vk_text),
                           flavor=flavor)
    proof = np.frombuffer(bytes.fromhex(read("proof.hex").strip()), np.uint8)
    bad = np.frombuffer(bytes.fromhex(read("proof_invalid.hex").strip()), np.uint8)
    return plan, jplan, proof, bad, parse_public_inputs(read("public_input.hex"))


@functools.lru_cache(maxsize=None)
def _spec(name, proof: bytes) -> bool:
    _plan, jplan, _p, _b, pis = _load(name)
    return ref_verify(jplan, proof, pis)[0]


def _norm(x):
    """A value of either package as plain data: dataclasses as dicts of
    their fields, arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(e) for e in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return x


@pytest.mark.parametrize("name", list(SETS))
def test_plan_and_layout_match_jax(name):
    plan, jplan, proof, _bad, _pis = _load(name)
    for a, b in ((plan, jplan), (build_layout(plan), j_build_layout(jplan))):
        na, nb = _norm(a), _norm(b)
        assert list(na) == list(nb)
        for field in na:
            assert na[field] == nb[field], field
    assert build_layout(plan).proof_len == len(proof)


@pytest.mark.parametrize("name", CIRCUITS)
def test_verdicts_match_spec(name):
    plan, _jplan, proof, bad, pis = _load(name)
    batch = np.stack([proof, bad, proof]).copy()
    batch[2, 100] ^= 0x40  # bit-flipped row
    want = [_spec(name, bytes(row)) for row in batch]
    assert want == [True, False, False]
    v = TorchVerifier(plan, device="cpu")
    got = v.verify(batch, v.encode_public_inputs([pis] * 3), v.compute_y_hints(batch),
                   torch.Generator().manual_seed(5))
    assert got.tolist() == want
    assert v.msm_term_counts == SETS[name][4]


@pytest.mark.parametrize("name", list(SETS))
def test_chip_smoke_batch_construction(name):
    """circuit_batch's expected vector is the spec verifier's verdict on
    every row; the corrupted hint lands on an honest row."""
    plan, _jplan, proof, bad, _pis = _load(name)
    scalar_offset = list(build_layout(plan).scalar_offsets.values())[0]
    batch, expected = chip_smoke.circuit_batch(proof, bad, scalar_offset, 16)
    assert batch.shape == (16, len(proof)) and int((~expected).sum()) == 3
    assert [_spec(name, bytes(row)) for row in batch] == expected.tolist()
    assert expected[chip_smoke.CIRCUIT_HINT_ROW]
    hints = np.zeros((16, len(build_layout(plan).point_offsets), 25), np.int64)
    changed = chip_smoke.corrupt_hint(hints) != hints
    assert changed.sum() == 1 and changed[chip_smoke.CIRCUIT_HINT_ROW].any()
