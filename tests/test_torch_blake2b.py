"""The port's Blake2b and transcript hashes (plutus_halo2_tpu_torch/ops/
blake2b.py, the plain version of csrc/blake2b.cu behind
ops/cuda_blake.transcript_hashes) against hashlib, the JAX package's XLA
path (ops/blake2b.blake2b_256_prefixes + blake2b_256) and its Pallas
transcript kernel in interpret mode. Exact digests."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.ops.blake2b import blake2b_256 as j_blake  # noqa: E402
from plutus_halo2_tpu.ops.blake2b import blake2b_256_prefixes as j_prefixes  # noqa: E402
from plutus_halo2_tpu.ops.pallas_blake import make_transcript_kernel  # noqa: E402
from plutus_halo2_tpu_torch.ops import blake2b  # noqa: E402
from plutus_halo2_tpu_torch.ops.cuda_blake import transcript_hashes  # noqa: E402

# the simple_mul transcript's squeeze prefix lengths (9 squeezes, 1324-byte buffer)
SIMPLE_MUL_LENGTHS = (264, 265, 266, 463, 562, 1124, 1125, 1175, 1275)


def _buf(lengths, B=4, seed=42):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, size=(B, max(lengths) + 5), dtype=np.uint8)
    buf[2:] = buf[1]  # mostly-identical rows + distinct ones
    return buf


@pytest.mark.parametrize("lengths", [
    SIMPLE_MUL_LENGTHS,
    (1, 17, 128, 129, 300, 301, 555),   # block boundaries + odd sizes
    (128, 256, 384),                    # exact multiples
])
def test_prefix_hashes_match_hashlib_and_xla(lengths):
    buf = _buf(lengths)
    h1, h2 = transcript_hashes(torch.from_numpy(buf), list(lengths))
    b1, b2 = blake2b.words_to_bytes(h1).numpy(), blake2b.words_to_bytes(h2).numpy()
    x1 = np.asarray(jax.jit(lambda b: j_prefixes(b, list(lengths)))(buf))
    x2 = np.asarray(jax.jit(j_blake)(x1.reshape(-1, 32))).reshape(x1.shape)
    assert np.array_equal(b1, x1)
    assert np.array_equal(b2, x2)
    for r in range(2):
        for s, l in enumerate(lengths):
            e1 = hashlib.blake2b(bytes(buf[r, :l]), digest_size=32).digest()
            assert bytes(b1[r, s]) == e1
            assert bytes(b2[r, s]) == hashlib.blake2b(e1, digest_size=32).digest()


def test_transcript_words_match_pallas_kernel():
    """The (B, S, 8) LE64 word layout equals the Pallas transcript kernel's
    (interpret mode) on the simple_mul prefix lengths."""
    B = 8
    buf = _buf(SIMPLE_MUL_LENGTHS, B=B, seed=7)
    kern = make_transcript_kernel(list(SIMPLE_MUL_LENGTHS), lanes=B, interpret=True)
    k1, k2 = (np.asarray(x).astype(np.int64) for x in jax.jit(kern)(buf))
    h1, h2 = transcript_hashes(torch.from_numpy(buf), list(SIMPLE_MUL_LENGTHS))
    assert np.array_equal(h1.numpy(), k1)
    assert np.array_equal(h2.numpy(), k2)


@pytest.mark.parametrize("mlen", [0, 1, 127, 128, 129, 300])
def test_single_message_digest(mlen):
    rng = np.random.default_rng(mlen)
    msg = rng.integers(0, 256, size=(2, mlen), dtype=np.uint8)
    got = blake2b.blake2b_256(torch.from_numpy(msg)).numpy()
    for r in range(2):
        assert bytes(got[r]) == hashlib.blake2b(bytes(msg[r]), digest_size=32).digest()
