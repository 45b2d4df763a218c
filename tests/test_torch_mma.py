"""The tensor-core probe's plain versions (plutus_halo2_tpu_torch/ops/cuda_mma.py,
the plain twins of csrc/mma_probe.cu) against the JAX package's probe
(tools/mxu_probe.py): its three pallas_calls, run in interpret mode, give
exactly the port's results on the probe's own inputs. Also: the two chains
agree, the wrappers send CPU tensors to the plain versions, and the port's
probe runs on the CPU when asked to."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from plutus_halo2_tpu_torch.ops import cuda_mma  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _inputs(B):
    """tools/mxu_probe.py:34-37."""
    rng = np.random.default_rng(0)
    mat = rng.integers(0, 127, (96, 48)).astype(np.int8)
    vec = rng.integers(0, 127, (48, B)).astype(np.int8)
    return mat, vec


@pytest.fixture
def jax_probe_kernels(monkeypatch, tmp_path):
    """Runs tools/mxu_probe.py's main at batch B with every pallas_call in
    interpret mode; returns the three kernels it built (dot, int8 chain,
    bf16 chain), each a callable of (mat, vec)."""
    spec = importlib.util.spec_from_file_location("mxu_probe", os.path.join(ROOT, "tools", "mxu_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    built = []
    pallas_call = probe.pl.pallas_call

    def interpreted(*args, **kwargs):
        fn = pallas_call(*args, **dict(kwargs, interpret=True))
        built.append(fn)
        return fn

    monkeypatch.setattr(probe.pl, "pallas_call", interpreted)
    monkeypatch.setenv("PH2_TPU_CACHE", str(tmp_path))

    def run(B):
        built.clear()
        monkeypatch.setattr(sys, "argv", ["mxu_probe", str(B)])
        probe.main()
        assert len(built) == 3
        return list(built)

    return run


@pytest.mark.parametrize("B", [16, 20, 128])
def test_plain_versions_equal_the_jax_probe_kernels(jax_probe_kernels, B):
    dot, chain8, chain16 = jax_probe_kernels(B)
    mat, vec = _inputs(B)
    m_t, v_t = torch.from_numpy(mat), torch.from_numpy(vec)
    got_dot = cuda_mma.int8_dot_plain(m_t, v_t).numpy()
    got_chain = cuda_mma.chain_plain(m_t, v_t).numpy()
    assert got_dot.dtype == got_chain.dtype == np.int32
    assert np.array_equal(np.asarray(dot(jnp.asarray(mat), jnp.asarray(vec))), got_dot)
    assert np.array_equal(np.asarray(chain8(jnp.asarray(mat), jnp.asarray(vec))), got_chain)
    assert np.array_equal(np.asarray(chain16(jnp.asarray(mat), jnp.asarray(vec))), got_chain)


@pytest.mark.parametrize("B,steps", [(1, 200), (37, 200), (5, 0), (5, 3)])
def test_chains_agree_and_match_numpy(B, steps):
    mat, vec = _inputs(B)
    m_t, v_t = torch.from_numpy(mat), torch.from_numpy(vec)
    m, want = mat.astype(np.int64), vec.astype(np.int64)
    for _ in range(steps):  # acc <- ((mat . acc) & 0x7F)[:48] in numpy int64
        want = ((m @ want) & 0x7F)[:48]
    assert np.array_equal(cuda_mma.int8_chain(m_t, v_t, steps).numpy(), want)
    assert np.array_equal(cuda_mma.bf16_chain(m_t, v_t, steps).numpy(), want)
    assert np.array_equal(cuda_mma.int8_dot(m_t, v_t).numpy(), mat.astype(np.int64) @ vec.astype(np.int64))


def test_cpu_tensors_go_to_the_plain_versions(monkeypatch):
    """On the CPU no wrapper loads the kernel library or counts a launch."""
    from plutus_halo2_tpu_torch.ops import _build

    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    mat, vec = (torch.from_numpy(a) for a in _inputs(9))
    before = [f.launches for f in (cuda_mma.int8_dot, cuda_mma.int8_chain, cuda_mma.bf16_chain)]
    assert torch.equal(cuda_mma.int8_dot(mat, vec), cuda_mma.int8_dot_plain(mat, vec))
    assert torch.equal(cuda_mma.int8_chain(mat, vec, 4), cuda_mma.chain_plain(mat, vec, 4))
    assert torch.equal(cuda_mma.bf16_chain(mat, vec, 4), cuda_mma.chain_plain(mat, vec, 4))
    assert [f.launches for f in (cuda_mma.int8_dot, cuda_mma.int8_chain, cuda_mma.bf16_chain)] == before


def test_negative_steps_raise():
    mat, vec = (torch.from_numpy(a) for a in _inputs(2))
    with pytest.raises(ValueError, match="steps"):
        cuda_mma.int8_chain(mat, vec, -1)


def test_probe_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "plutus_halo2_tpu_torch.tools.mma_probe", "16", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "device=cpu B=16"
    assert any(line.startswith("int8 dot OK run=") for line in lines)
    assert sum("us/product" in line for line in lines) == 2
    assert lines[-1] == "cpu"
