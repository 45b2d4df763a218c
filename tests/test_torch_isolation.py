"""The port stands alone: importing every module of plutus_halo2_tpu_torch
and chip_smoke pulls in neither jax nor the JAX package; its entry point
runs on the card unless asked for the CPU and raises without one; modes
that are not ported yet raise instead of silently downgrading."""

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
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15  # every module of the package was imported
    assert bad == "[]"


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


@pytest.mark.parametrize("mode", ["aggregate", "exact", True])
def test_unported_subgroup_modes_raise(plan, mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchVerifier(plan, device="cpu", subgroup_check=mode)


def test_default_mode_is_aggregate_and_raises(plan):
    with pytest.raises(NotImplementedError, match="aggregate"):
        TorchVerifier(plan, device="cpu")


def test_y_hints_raise(plan):
    v = TorchVerifier(plan, device="cpu", subgroup_check="off")
    proof = torch.zeros((1, v.layout.proof_len), dtype=torch.uint8)
    pis = torch.zeros((1, v.n_pi, 17), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        v.verify(proof, pis, y_hints=torch.zeros((1, 10, 25), dtype=torch.int64))


def test_wrappers_reject_cpu_launch_paths_for_bad_cuda_inputs():
    """A wrapper's argument check raises on a non-CUDA tensor (the CPU path
    only ever dispatches by device, never by failure)."""
    from plutus_halo2_tpu_torch.ops import _build

    with pytest.raises(ValueError, match="CUDA"):
        _build.require(torch.zeros(3), "x", torch.float32)

