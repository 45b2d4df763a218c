"""plutus_halo2_tpu_torch — the batched Halo2/KZG verifier in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a), and the proof
generators (keygen, prove) over CUDA Fr polynomial kernels.

A port of the JAX package ``plutus_halo2_tpu``, which stays the reference.
This package imports torch and numpy only; it never imports jax or any
module of ``plutus_halo2_tpu`` and keeps its own copies of the host-side
modules it needs.

Layout (mirrors the JAX package):
  refimpl/  — copies of the pure-Python field/curve/constraint-system spec,
              the spec verifier, keygen, the prover, the SRS, Jubjub, Rescue
  models/   — CircuitPlan IR, static transcript layout, TorchVerifier
  ops/      — 16-bit-limb field, Blake2b, G1, tower and pairing math in
              PyTorch, plus the kernel wrappers (``cuda_*.py``) and the
              nvcc/ctypes loader (``_build.py``)
  csrc/     — the CUDA C++ sources of the kernels
  utils/    — VK / public-input parsing, the committed artifact sets
  examples/ — the example scripts (``python3 -m plutus_halo2_tpu_torch.examples.<name>``)
"""

__version__ = "0.1.0"
