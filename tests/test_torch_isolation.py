"""The port stands alone: importing every module of plutus_halo2_tpu_torch
and chip_smoke pulls in neither jax nor the JAX package; its entry point
runs on the card unless asked for the CPU and raises without one; the
subgroup modes and their settings, and the arguments the verifier refuses
instead of silently downgrading."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit  # noqa: E402
from plutus_halo2_tpu_torch.models import verifier_torch  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import vk_from_json  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = """
import importlib, pkgutil, sys
import plutus_halo2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "plutus_halo2_tpu" or m.startswith("plutus_halo2_tpu."))
print(len(names), bad)
print(" ".join(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.strip().splitlines()
    n, bad = counts.split(" ", 1)
    assert int(n) >= 15  # every module of the package was imported
    assert bad == "[]"
    for mod in ("refimpl.transcript", "refimpl.lagrange", "refimpl.multiopen", "refimpl.pairing",
                "refimpl.verifier", "utils.tracing", "utils.serialization", "utils.artifacts",
                "parallel.mesh", "tools.submit", "tools.multihost_smoke", "bench", "entry",
                "refimpl.poly", "refimpl.srs", "refimpl.keygen", "refimpl.prover", "refimpl.jubjub",
                "refimpl.rescue", "ops.poly", "ops.cuda_poly", "examples.simple_mul", "examples.lookup_table",
                "examples.atms", "examples.equations_test"):
        assert f"plutus_halo2_tpu_torch.{mod}" in names.split(), mod


@pytest.fixture(scope="module")
def plan():
    with open(os.path.join(ROOT, "examples", "artifacts", "simple_mul_vk.json")) as f:
        return plan_from_vk(SimpleMulCircuit(), vk_from_json(f.read()))


def test_default_device_is_cuda_and_raises_without_one(plan, monkeypatch):
    monkeypatch.setattr(verifier_torch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVerifier(plan, subgroup_check="off")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVerifier(plan, device="cuda", subgroup_check="off")
    assert TorchVerifier(plan, device="cpu", subgroup_check="off").device.type == "cpu"


def test_default_mode_is_aggregate(plan):
    v = TorchVerifier(plan, device="cpu")
    assert (v.subgroup_check, v.subgroup_rounds) == ("aggregate", 1)
    assert v.subgroup_weights(torch.Generator().manual_seed(0)).shape == (1, 10)


@pytest.mark.parametrize("mode,name", [(True, "exact"), (False, "off"), ("exact", "exact"),
                                       ("off", "off")])
def test_subgroup_mode_names(plan, mode, name):
    v = TorchVerifier(plan, device="cpu", subgroup_check=mode)
    assert v.subgroup_check == name
    assert v.subgroup_weights() is None


@pytest.mark.parametrize("kwargs", [{"subgroup_check": "strict"}, {"subgroup_rounds": 0}])
def test_bad_subgroup_settings_raise(plan, kwargs):
    with pytest.raises(ValueError):
        TorchVerifier(plan, device="cpu", **kwargs)


def _zeros(v, B):
    proof = torch.zeros((B, v.layout.proof_len), dtype=torch.uint8)
    return proof, torch.zeros((B, v.n_pi, 17), dtype=torch.int64)


def test_core_in_aggregate_mode_needs_weights(plan):
    v = TorchVerifier(plan, device="cpu")
    with pytest.raises(ValueError, match="sub_weights"):
        v.core(*_zeros(v, 2))


def test_y_hints_of_the_wrong_shape_raise(plan):
    v = TorchVerifier(plan, device="cpu", subgroup_check="off")
    with pytest.raises(ValueError, match="y_hints"):
        v.core(*_zeros(v, 2), y_hints=torch.zeros((2, 9, 25), dtype=torch.int64))


@pytest.mark.parametrize("B,group", [(6, 4), (8, 0)])
def test_verify_rlc_group_must_divide_batch(plan, B, group):
    v = TorchVerifier(plan, device="cpu")
    with pytest.raises(ValueError, match="group"):
        v.verify_rlc(*_zeros(v, B), group=group)


def test_wrappers_reject_cpu_launch_paths_for_bad_cuda_inputs():
    """A wrapper's argument check raises on a non-CUDA tensor (the CPU path
    only ever dispatches by device, never by failure)."""
    from plutus_halo2_tpu_torch.ops import _build

    with pytest.raises(ValueError, match="CUDA"):
        _build.require(torch.zeros(3), "x", torch.float32)

