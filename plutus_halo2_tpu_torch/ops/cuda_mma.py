"""Tensor-core probe kernels (``csrc/mma_probe.cu``, ``csrc/mma_chain.cu``),
their plain PyTorch versions and their launch counters.

They replace the three ``pallas_call``s of ``tools/mxu_probe.py`` (``:46``,
``:101``, ``:122``): a constant (96, 48) int8 matrix times a (48, B) int8
batch, the shape of a Montgomery reduction by a constant modulus in 8-bit
sublimbs (``2 L8 x L8`` for a 24-limb field). The layout is the JAX
probe's:

  ``int8_dot(mat, vec)``              -> (96, B) int32, mat . vec;
  ``int8_chain(mat, vec, steps=200)`` -> (48, B) int32 after ``steps``
      dependent steps acc <- ((mat . acc) & 0x7F)[:48], acc0 = vec;
  ``bf16_chain(mat, vec, steps=200)`` -> the same chain through bf16
      operands with f32 sums (``csrc/mma_chain.cu``: a warp's 16 batch
      columns held in mma.sync registers for the whole chain,
      ``CHAIN_WARPS`` warps a block).

Every value is an integer in [0, 127] and a 48-term sum stays below 2^20,
so both chains compute one integer function exactly: one plain version,
``chain_plain``, serves both. The plain versions multiply in int64 by
broadcasting (CUDA has no integer ``torch.matmul``), never through a float
product. A CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises."""

from __future__ import annotations

import torch

from . import _build

M, K = 96, 48  # out rows (2 L8) x in sublimbs (L8)
MASK = 0x7F
STEPS = 200
CHAIN_WARPS = 1  # warps a block of the bf16 chain (1-8), read at each launch


def int8_dot_plain(mat, vec):
    return (mat.to(torch.int64)[:, :, None] * vec.to(torch.int64)[None]).sum(1).to(torch.int32)


def chain_plain(mat, vec, steps: int = STEPS):
    m = mat.to(torch.int64)[:, :, None]
    acc = vec.to(torch.int64)
    for _ in range(steps):
        acc = ((m * acc[None]).sum(1) & MASK)[:K]
    return acc.to(torch.int32)


def _launch(fn: str, mat, vec, rows: int, *steps):
    _build.require(mat, "mat", torch.int8, (M, K))
    _build.require(vec, "vec", torch.int8, (K, None))
    if mat.data_ptr() % 4:
        raise ValueError("mat: the kernels read its rows as 4-byte words; expected a 4-byte aligned tensor")
    B = vec.shape[1]
    out = torch.empty((rows, B), dtype=torch.int32, device=vec.device)
    lib = _build.library()
    _build.check(getattr(lib, fn)(_build.ptr(mat), _build.ptr(vec), _build.ptr(out), B, *steps,
                                  _build.stream_ptr()), fn)
    return out


def _check_steps(steps: int):
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def int8_dot(mat, vec):
    """mat (96, 48) int8, vec (48, B) int8 -> (96, B) int32."""
    if vec.device.type == "cpu":
        return int8_dot_plain(mat, vec)
    out = _launch("ph2_mma_int8_dot", mat, vec, M)
    int8_dot.launches += 1
    return out


int8_dot.launches = 0


def int8_chain(mat, vec, steps: int = STEPS):
    """The chain on int8 tensor-core products -> (48, B) int32."""
    _check_steps(steps)
    if vec.device.type == "cpu":
        return chain_plain(mat, vec, steps)
    out = _launch("ph2_mma_int8_chain", mat, vec, K, steps)
    int8_chain.launches += 1
    return out


int8_chain.launches = 0


def bf16_chain(mat, vec, steps: int = STEPS):
    """The chain on bf16 tensor-core products with f32 sums -> (48, B) int32."""
    _check_steps(steps)
    if vec.device.type == "cpu":
        return chain_plain(mat, vec, steps)
    out = _launch("ph2_mma_bf16_chain", mat, vec, K, steps, CHAIN_WARPS)
    bf16_chain.launches += 1
    return out


bf16_chain.launches = 0
