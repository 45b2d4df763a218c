"""Pairing-check kernel (``csrc/pairing.cu``), its plain PyTorch version and
its launch counter.

Replaces ``plutus_halo2_tpu/ops/pallas_pairing.py:419`` ``make_pairing_check``:
for each row, e(el, Q1) * e(er, Q2) == 1 with the G2 ladders of Q1, Q2
prepared on the host (``ops/pairing.prepare_g2``). The plain version is
``ops/pairing.pairing_check_projective`` (the JAX package's
``jpair.pairing_check`` behind the verifier's affine conversion).

The kernel runs the programs of ``ops/pairing_program.py`` with a group of
``LANES`` lanes per row and ``ROWS_PER_BLOCK`` rows in a block (both read
at each launch; ``python3 -m plutus_halo2_tpu_torch.block_sweep`` sweeps
them)."""

from __future__ import annotations

import numpy as np
import torch

from . import _build, pairing_program
from .limb import FP_SPEC
from .pairing import pairing_check_projective

_KINDS = ("dbl_lam", "dbl_c", "add_lam", "add_c")
LANES = 32  # lanes per row: 16 or 32
ROWS_PER_BLOCK = None  # None: enough rows per block to fill the SMs once, at most MAX_ROWS_PER_BLOCK
MAX_ROWS_PER_BLOCK = 8
_TABLES: dict = {}


def _tables_on(device):
    """The program table and the constant slots (kernel words) on `device`,
    built once per process."""
    key = str(device)
    if key not in _TABLES:
        tab, scratch, tab_words = pairing_program.kernel_tables()
        consts = np.array([w for v in pairing_program.const_ints() for w in _build.words(v, 12)],
                          dtype=np.uint32).view(np.int32)
        _TABLES[key] = (torch.from_numpy(tab).to(device), torch.from_numpy(consts).to(device),
                        pairing_program.row_slots(scratch), tab_words)
    return _TABLES[key]


class PreparedPair:
    """The two prepared G2 ladders of a pairing check, and their line
    constants in the kernel's layout: (2, 68, 2, 2, 12) 32-bit words of the
    values times 2^384 mod p (per pair the doubling lines of the 63 Miller
    steps, then the addition lines of the 5 one-bits), copied to each device
    once."""

    def __init__(self, prep1: dict, prep2: dict):
        self.prep1, self.prep2 = prep1, prep2
        vals = []
        for prep in (prep1, prep2):
            for i in range(len(prep["dbl_lam"])):
                for kind in _KINDS:
                    for c in range(2):
                        vals += _build.kernel_fp(FP_SPEC.from_mont_int(prep[kind][i, c]))
        self.lines = pairing_program.compact_ladder(
            np.array(vals, dtype=np.uint32).view(np.int32).reshape(2, -1, 4, 2, 12))
        self._dev: dict = {}

    def lines_on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self.lines.copy()).to(device)
            self._dev[key] = t
        return t


def rows_per_block(B: int, device) -> int:
    """The fewest rows per block that put every row in one wave of blocks,
    one block per SM (at most MAX_ROWS_PER_BLOCK): one row per block at
    the RLC group check's 128 rows, 8 at 1024 rows on 132 SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(MAX_ROWS_PER_BLOCK, max(1, -(-B // sms)))


def pairing_check_plain(el, er, pp: PreparedPair, enable=None):
    ok = pairing_check_projective(el, er, pp.prep1, pp.prep2)
    return ok if enable is None else torch.where(enable.reshape(()).bool(), ok, True)


def pairing_check(el, er, pp: PreparedPair, phases=None, enable=None):
    """el, er (B, 3, 25) projective Montgomery -> (B,) bool; with `enable`
    (a one-element tensor on el's device) false, every row true. `phases`, a
    (B, 10) int64 CUDA tensor, receives each row's clock64() at the start
    and after the affine conversion, the Miller loop, the easy part, the
    five chains and the tail, then the cycles its stages of products,
    linear combinations and inversions took and the number of stages (a
    row of two identities stops after the start)."""
    if el.device.type == "cpu":
        return pairing_check_plain(el, er, pp, enable)
    _build.require(el, "el", torch.int64, (None, 3, FP_SPEC.L))
    _build.require(er, "er", torch.int64, tuple(el.shape))
    B = el.shape[0]
    lines = pp.lines_on(el.device)
    if lines.shape[1] != 63 + pairing_program.N_ADD:
        raise ValueError("pairing kernel expects 63-step ladders")
    tab, consts, row_slots, tab_words = _tables_on(el.device)
    rows = ROWS_PER_BLOCK or rows_per_block(B, el.device)
    out = torch.empty((B,), dtype=torch.int32, device=el.device)
    if phases is not None:
        _build.require(phases, "phases", torch.int64, (B, 10))
    if enable is not None:
        enable = enable.reshape(1).to(torch.int32)
        _build.require(enable, "enable", torch.int32, (1,))
    lib = _build.library()
    _build.check(lib.ph2_pairing_check(_build.ptr(el), _build.ptr(er), _build.ptr(lines), _build.ptr(tab),
                                       _build.ptr(consts), _build.ptr(out),
                                       _build.ptr_or_none(phases), _build.ptr_or_none(enable), B, LANES, rows,
                                       row_slots, tab_words, _build.stream_ptr()),
                 "ph2_pairing_check")
    pairing_check.launches += 1
    return out != 0


pairing_check.launches = 0
