"""Pairing-check kernel (``csrc/pairing.cu``), its plain PyTorch version and
its launch counter.

Replaces ``plutus_halo2_tpu/ops/pallas_pairing.py:419`` ``make_pairing_check``:
for each row, e(el, Q1) * e(er, Q2) == 1 with the G2 ladders of Q1, Q2
prepared on the host (``ops/pairing.prepare_g2``). The plain version is
``ops/pairing.pairing_check_projective`` (the JAX package's
``jpair.pairing_check`` behind the verifier's affine conversion)."""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .limb import FP_SPEC
from .pairing import pairing_check_projective

_KINDS = ("dbl_lam", "dbl_c", "add_lam", "add_c")


class PreparedPair:
    """The two prepared G2 ladders of a pairing check, and their line
    constants in the kernel's layout: (2, 63, 4, 2, 12) 32-bit words of the
    values times 2^384 mod p, copied to each device once."""

    def __init__(self, prep1: dict, prep2: dict):
        self.prep1, self.prep2 = prep1, prep2
        vals = []
        for prep in (prep1, prep2):
            for i in range(len(prep["dbl_lam"])):
                for kind in _KINDS:
                    for c in range(2):
                        vals += _build.kernel_fp(FP_SPEC.from_mont_int(prep[kind][i, c]))
        self.lines = np.array(vals, dtype=np.uint32).view(np.int32).reshape(2, -1, 4, 2, 12)
        self._dev: dict = {}

    def lines_on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self.lines.copy()).to(device)
            self._dev[key] = t
        return t


def pairing_check_plain(el, er, pp: PreparedPair):
    return pairing_check_projective(el, er, pp.prep1, pp.prep2)


def pairing_check(el, er, pp: PreparedPair):
    """el, er (B, 3, 25) projective Montgomery -> (B,) bool."""
    if el.device.type == "cpu":
        return pairing_check_plain(el, er, pp)
    _build.require(el, "el", torch.int64, (None, 3, FP_SPEC.L))
    _build.require(er, "er", torch.int64, tuple(el.shape))
    B = el.shape[0]
    lines = pp.lines_on(el.device)
    if lines.shape[1] != 63:
        raise ValueError("pairing kernel expects 63-step ladders")
    out = torch.empty((B,), dtype=torch.int32, device=el.device)
    lib = _build.library()
    _build.check(lib.ph2_pairing_check(_build.ptr(el), _build.ptr(er), _build.ptr(lines),
                                       _build.ptr(out), B, _build.BLOCK_THREADS,
                                       _build.stream_ptr()),
                 "ph2_pairing_check")
    pairing_check.launches += 1
    return out != 0


pairing_check.launches = 0
