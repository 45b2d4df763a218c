"""The Fr glue's kernels on the card (``csrc/fr_glue.cu`` through
``ops/cuda_fr.py``; ``limb.fr`` sends every op on a CUDA tensor there):
each op limb for limb against the plain ``limb.Field`` on the verifier's
shapes at B = 1024, with no layout copy; and for each configuration of the
benchmark (simple_mul, atms_with_lookups_50_90) one captured ``verify()``
and one ``verify_rlc_device()`` whose verdicts equal those of the
plain-torch glue (``limb.Field`` in ``verifier_torch``, the path before the
kernels) on the same inputs and weights, with no Fr op on the plain path,
no layout copy, and at least 70 % fewer kernel nodes in each program than
the plain glue's. Imports no JAX; run with ``python -m pytest
tests/test_torch_fr_glue_gpu.py -m gpu --noconftest`` on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plutus_halo2_tpu_torch.models import verifier_torch  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_fr, limb  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FR_SPEC  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set  # noqa: E402

pytestmark = pytest.mark.gpu
L = FR_SPEC.L


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _canon(rng, shape, dev):
    """Random canonical Fr limbs (shape..., 17), 0, 1 and N - 1 first."""
    n = int(np.prod(shape))
    vals = [0, 1, FR_SPEC.N - 1] + [int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(n)]
    return torch.from_numpy(np.stack([FR_SPEC.encode(v) for v in vals[:n]]).reshape(*shape, L)).to(dev)


def test_kernels_equal_plain_on_the_verifiers_shapes(dev):
    B = 1024
    rng = np.random.default_rng(17)
    x, consts, pooled = _canon(rng, (B,), dev), _canon(rng, (1, 36), dev), _canon(rng, (B, 40), dev)
    words = _canon(rng, (2, B, 9), dev)  # the transcript's squeezes, read as vals[:, s]
    below_2_256 = torch.from_numpy(rng.integers(0, 1 << 16, size=(B, 41, L))).to(dev)
    below_2_256[..., -1] = 0
    below_2_256[0] = 0xFFFF  # 2^256 - 1
    below_2_256[0, :, -1] = 0
    checks = [
        lambda f: f.mul(x[:, None, :], consts),
        lambda f: f.sub(x[:, None, :], consts),
        lambda f: f.mul(pooled[:, 2:7, :], consts[:, 10:15, :]),
        lambda f: f.add(words[0][:, 3], f.mul(words[1][:, 3], consts[0, 0])),
        lambda f: f.to_mont(below_2_256),
        lambda f: f.from_mont(pooled),
        lambda f: f.neg(x),
        lambda f: f.sqr(pooled[:, 5]),
        lambda f: f.sum_lazy(pooled[:, 1:6, :], dim=-2),
        lambda f: f.dot_lazy(pooled[:, 3:6, :], pooled[:, 30:33, :], dim=-2),
        lambda f: f.batch_inv(pooled, dim=-2),
        lambda f: f.pow(x, 1 << 20),
    ]
    copies, launches = cuda_fr.layout_copies, cuda_fr.mul.launches
    plain = limb.Field(FR_SPEC)
    for i, fn in enumerate(checks):
        got, want = fn(limb.fr), fn(plain)
        assert torch.equal(got, want), i
    assert cuda_fr.layout_copies == copies
    assert cuda_fr.mul.launches > launches


def _run(v, batch, pis, B):
    """One captured verify() and one verify_rlc_device() (group 8): their
    verdicts, the suspect count, and each program's kernel nodes."""
    gen = torch.Generator().manual_seed(7)
    hints = v.compute_y_hints(batch)
    pis_b = v.encode_public_inputs([pis] * B)
    ok = v.verify(batch, pis_b, hints, gen).cpu().tolist()
    rlc = v.verify_rlc_device(batch, pis_b, v.rlc_weights(B, gen), hints, group=8, generator=gen)
    nodes = {key[0]: prog.nodes["kernel"] for key, prog in v.programs.cache.items()}
    return ok, rlc[0].cpu().tolist(), int(rlc[1]), nodes


@pytest.mark.parametrize("name", ["simple_mul", "atms_with_lookups_50_90"])
def test_captured_bodies_against_the_plain_glue(dev, name, monkeypatch):
    B = 64
    plan, proof, bad, pis = load_set(name)
    batch = np.stack([np.frombuffer(proof, np.uint8)] * B)
    batch[5] = np.frombuffer(bad, np.uint8)
    batch[9, 100] ^= 0x40
    plain_on_cuda, copies, launches = cuda_fr.plain_on_cuda, cuda_fr.layout_copies, cuda_fr.mul.launches
    got = _run(TorchVerifier(plan, device=dev), batch, pis, B)
    assert cuda_fr.plain_on_cuda == plain_on_cuda and cuda_fr.layout_copies == copies
    assert cuda_fr.mul.launches > launches
    monkeypatch.setattr(verifier_torch, "fr", limb.Field(FR_SPEC))  # the plain-torch glue
    want = _run(TorchVerifier(plan, device=dev), batch, pis, B)
    assert cuda_fr.plain_on_cuda > plain_on_cuda
    assert got[:3] == want[:3]
    assert got[0] == got[1] == [i not in (5, 9) for i in range(B)]
    assert set(got[3]) == {"verify", "rlc"}
    for entry, nodes in got[3].items():
        assert nodes <= 0.3 * want[3][entry], (entry, nodes, want[3][entry])
