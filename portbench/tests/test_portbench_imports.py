"""No module under portbench/ imports JAX or the JAX package, and the
reference (reference/ and the configurations' circuit files) imports
nothing of the port either. Top-level module names are compared whole:
the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run, spec

FILES = sorted(spec.HERE.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "plutus_halo2_tpu"}
REFERENCE = [f for f in FILES if f.parent.name == "reference" or f.parent.name == "configs"]


def _top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not _top_level_imports(path) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert not _top_level_imports(path) & (JAX | {"plutus_halo2_tpu_torch", "torch"})


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.verifier, portbench.reference.artifacts, portbench.roofline, "
            "portbench.check, portbench.traffic; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True, text=True,
                         check=True, timeout=120)
    loaded = set(out.stdout.split())
    assert "portbench" in loaded and not loaded & (JAX | {"plutus_halo2_tpu_torch"})


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "plutus_halo2_tpu_torch_fake_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "plutus_halo2_tpu.fake_probe", object())
    assert run.forbidden_modules() == ["plutus_halo2_tpu"]
