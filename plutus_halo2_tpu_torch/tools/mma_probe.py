"""Tensor-core probe: the counterpart of the JAX package's
``tools/mxu_probe.py``.

    python3 -m plutus_halo2_tpu_torch.tools.mma_probe [B] [--device cpu]

The question: can the reduction half of a Montgomery product, which
multiplies by the CONST modulus (in 8-bit sublimbs a (2 L8 x L8) constant
Toeplitz matrix times a (L8, B) batch), run on Hopper's tensor cores? The
probe builds the JAX probe's inputs (``default_rng(0)``, a (96, 48) and a
(48, B) int8 matrix of integers in [0, 127)), checks the single int8
product against the exact integer product and both 200-step chains
against the exact plain chain (``cuda_mma.chain_plain`` on CPU copies), and
prints the build time, the single
product's ms and each chain's ms and us per product (the least of 3 calls
after a first one; CUDA events on the card), then the card's name and power
limit. B defaults to 128. Runs on the card (hand-written WMMA kernels,
``csrc/mma_probe.cu``) unless ``--device cpu`` asks for the plain versions;
raises without a card."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.verifier_torch import resolve_device
from ..ops import _build, cuda_mma
from ..utils.profiling import call_ms, card_line


def _best_ms(fn, dev, reps: int = 3) -> float:
    return min(call_ms(fn, dev) for _ in range(reps))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=128, help="batch columns (default 128)")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, steps = args.B, cuda_mma.STEPS
    print(f"device={dev} B={B}", flush=True)

    rng = np.random.default_rng(0)
    mat_np = rng.integers(0, 127, (cuda_mma.M, cuda_mma.K)).astype(np.int8)
    vec_np = rng.integers(0, 127, (cuda_mma.K, B)).astype(np.int8)
    mat, vec = torch.from_numpy(mat_np).to(dev), torch.from_numpy(vec_np).to(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.library()
    print(f"build={time.perf_counter() - t0:.1f}s", flush=True)

    res = {"device": str(dev), "B": B, "card": card_line(dev)}
    out = cuda_mma.int8_dot(mat, vec)
    if not np.array_equal(out.cpu().numpy(), mat_np.astype(np.int32) @ vec_np.astype(np.int32)):
        raise SystemExit("mma_probe: int8 product wrong")
    res["int8_dot_ms"] = _best_ms(lambda: cuda_mma.int8_dot(mat, vec), dev)
    print(f"int8 dot OK run={res['int8_dot_ms']:.3f} ms", flush=True)

    want = cuda_mma.chain_plain(mat.cpu(), vec.cpu(), steps)
    for name, fn in (("int8", cuda_mma.int8_chain), ("bf16", cuda_mma.bf16_chain)):
        if not torch.equal(fn(mat, vec, steps).cpu(), want):
            raise SystemExit(f"mma_probe: {name} chain differs from the exact chain")
        ms = _best_ms(lambda: fn(mat, vec, steps), dev)
        res[f"{name}_chain_ms"] = ms
        print(f"{steps}-chain {name} OK run={ms:.3f} ms -> {ms * 1e3 / steps:.2f} us/product", flush=True)
    print(res["card"], flush=True)
    return res


if __name__ == "__main__":
    main()
