"""Builds the CUDA kernels in ``csrc/`` with nvcc and loads them with ctypes.

One ``nvcc -c`` per source, all started together, then one link into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). The library links CUDA's shared runtime, so
it shares one runtime, and its stream and module state, with PyTorch. The field constants are generated into
``field_consts.cuh`` from the port's ``refimpl/field.py`` first, so the
kernels and the Python side share one source of truth. The library is named
by a hash of everything that goes into it and built at first use into
``plutus_halo2_tpu_torch/_build/`` (listed in ``.gitignore``).

There is no fallback: a missing nvcc or a failed compile raises."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..refimpl.field import BLS_X, P, Q

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("field_test.cu", "blake2b.cu", "pow.cu", "msm.cu", "pairing.cu", "decompress.cu",
           "subgroup.cu", "mma_probe.cu", "mma_chain.cu", "poly.cu", "graphs.cu", "fr_glue.cu", "sqrt_decode.cu")
HEADERS = ("field.cuh", "lanes.cuh", "curve.cuh", "group.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points: (argtypes); every one returns a CUDA error code as int (the
# kernels' launchers cudaGetLastError())
SIGNATURES = {
    "ph2_mont_mul_fp": (_P, _P, _P, _I, _P),
    "ph2_mont_mul_fr": (_P, _P, _P, _I, _P),
    "ph2_fp_step_probe": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ph2_lanes_step_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ph2_pow_fp": (_P, _P, _I, _P, _I, _P),
    "ph2_pow_fr": (_P, _P, _I, _P, _I, _P),
    "ph2_transcript": (_P, _I, _I, _P, _I, _I, _P, _P, _P),
    "ph2_msm": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ph2_pairing_check": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ph2_decompress": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ph2_subgroup": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ph2_sqrt_decode": (_P, _P, _P, _I, _P, _I, _P),
    "ph2_mma_int8_dot": (_P, _P, _P, _I, _P),
    "ph2_mma_int8_chain": (_P, _P, _P, _I, _I, _P),
    "ph2_mma_bf16_chain": (_P, _P, _P, _I, _I, _P),
    "ph2_fr_ntt": (_P, _P, _L, _I, _P, _I, _I, _P, _P, _P, _P),
    "ph2_fr_mul_array": (_P, _P, _P, _L, _P),
    "ph2_fr_scale_array": (_P, _P, _P, _L, _P),
    "ph2_fr_powers_mul_array": (_P, _P, _L, _P, _I, _I, _P, _P, _P),
    "ph2_graph_census": (_P, _P, _P, _P, _I, _P),
    "ph2_graph_set_events": (_P, _P, _P, _I),
    "ph2_event_record": (_P, _P),
    "ph2_fr_glue": (_I, _P, _P, _P, _P, _P),
}


def words(x: int, n: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def kernel_fp(x: int) -> list[int]:
    """An Fp value in the kernels' domain: 12 words of x * 2^384 mod p."""
    return words(x * (1 << 384) % P, 12)


def _arr(name: str, vals, ctype: str = "uint32_t") -> str:
    body = ", ".join(f"0x{v:08x}u" for v in vals)
    return f"static __constant__ {ctype} {name}[{len(vals)}] = {{{body}}};\n"


def field_consts_header() -> str:
    """The generated constants: per field the modulus, -N^-1 mod 2^32, R mod
    N (one in the kernel domain), and the two boundary factors that move a
    value between the port's 16-bit-limb domain (R = 2^(16 L)) and the
    kernels' 32-bit-word domain (R = 2^(32 W)); the curve constants of
    hinted decompression (R^2 mod p, b = 4, (p + 1) / 2 as plain words) and
    the cube root of unity beta of the subgroup test; R^3 mod p (plain
    words), which turns the pairing kernel's Euclidean inverse into the
    Montgomery domain; R^2 mod q (plain words), the poly kernels' second
    factor in a product of two canonical arrays; 2^288 and 2^304 mod q
    (plain words), the Fr glue kernels' factors that reduce a wide sum; and
    the pairing kernel's row layout, program ids and slot-reference bases."""
    # imported here: they import ops/limb.py, which imports ops/cuda_fr.py
    # and so this module
    from . import pairing_program
    from .curve import BETA

    out = ["// generated by plutus_halo2_tpu_torch/ops/_build.py — do not edit\n",
           "#pragma once\n#include <cstdint>\n"]
    for name, mod, nw, l16 in (("FP", P, 12, 25), ("FR", Q, 8, 17)):
        rk, rp = 32 * nw, 16 * l16
        out.append(_arr(f"{name}_MOD", words(mod, nw)))
        out.append(f"static __constant__ uint32_t {name}_N0 = 0x{(-pow(mod, -1, 1 << 32)) % (1 << 32):08x}u;\n")
        out.append(_arr(f"{name}_ONE", words((1 << rk) % mod, nw)))
        # port (R = 2^rp) -> kernel (R = 2^rk): times 2^(2 rk - rp) / R_k
        out.append(_arr(f"{name}_TO_K", words(pow(2, 2 * rk - rp, mod), nw)))
        # kernel -> port: times 2^rp / R_k
        out.append(_arr(f"{name}_FROM_K", words(pow(2, rp, mod), nw)))
    out.append(_arr("FP_R2K", kernel_fp(1 << 384)))
    out.append(_arr("FP_B4", kernel_fp(4)))
    out.append(_arr("FP_HALF", words((P + 1) >> 1, 12)))
    out.append(_arr("FP_BETA", kernel_fp(BETA)))
    out.append(_arr("FP_R3", words(pow(2, 3 * 384, P), 12)))
    out.append(_arr("FR_R2K", words(pow(2, 512, Q), 8)))
    out.append(_arr("FR_W288", words(pow(2, 288, Q), 8)))
    out.append(_arr("FR_W304", words(pow(2, 304, Q), 8)))
    out.append(f"static constexpr uint64_t BLS_X_ABS = 0x{BLS_X:016x}ull;\n")
    out.append(pairing_program.kernel_header())
    return "".join(out)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (sm_90a)")
    return nvcc


class _Library:
    """The built and loaded kernel library (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None
        self.log_path = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        t0 = time.perf_counter()
        consts = field_consts_header()
        h = hashlib.sha256(consts.encode())
        for name in SOURCES + HEADERS:
            h.update((CSRC / name).read_bytes())
        h.update(" ".join(ARCH).encode())
        tag = h.hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"libph2cuda-{tag}.so"
        self.log_path = BUILD_DIR / f"build-{tag}.log"
        if not lib_path.exists():
            self._compile(consts, tag, lib_path)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        return lib

    def _compile(self, consts: str, tag: str, lib_path: Path):
        nvcc = find_nvcc()
        work = BUILD_DIR / f"work-{tag}-{os.getpid()}"
        work.mkdir(parents=True, exist_ok=True)
        (work / "field_consts.cuh").write_text(consts)
        flags = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                        f"-I{work}", f"-I{CSRC}"]
        procs = []
        for src in SOURCES:
            obj = work / (src + ".o")
            cmd = [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src} (rc {p.returncode})\n{text}")
            if p.returncode:
                failed.append(src)
        if not failed:
            tmp = work / lib_path.name
            cmd = [nvcc, *ARCH, "-shared", "-cudart", "shared", "-o", str(tmp),
                   *[str(o) for _s, o, _p in procs]]
            p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {p.returncode})\n{p.stdout}")
            if p.returncode:
                failed.append("link")
            else:
                os.replace(tmp, lib_path)
        self.log_path.write_text("".join(log))
        if failed:  # the failed steps' own output first
            ordered = sorted(log, key=lambda e: e.split(" ", 2)[1] not in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(ordered)[:6000])


_LIBRARY = _Library()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return _LIBRARY.get()


def build_seconds() -> float | None:
    return _LIBRARY.build_seconds


def build_log() -> str:
    return _LIBRARY.log_path.read_text() if _LIBRARY.log_path and _LIBRARY.log_path.exists() else ""


def kernel_resources(name: str) -> list[dict]:
    """Registers, stack frame and spill bytes of each compiled entry function
    whose mangled name contains `name`, from the build log's ``-Xptxas -v``
    lines (empty before a build in this process)."""
    out, cur = [], None
    for line in build_log().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"function": m.group(1)} if name in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def launch_constant(source: str, name: str) -> int:
    """A launch-geometry constant of a kernel's launcher, where it is set:
    ``constexpr int <name> = <value>;`` in csrc/<source> (for reports and
    tests; the launchers take no geometry argument)."""
    m = re.search(rf"^constexpr int {name} = (\d+);", (CSRC / source).read_text(), re.M)
    if m is None:
        raise KeyError(f"{source} sets no constexpr int {name}")
    return int(m.group(1))


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_none(t):
    return None if t is None else ptr(t)


def require(t, name: str, dtype, shape=None):
    """Wrapper argument check: a contiguous CUDA tensor of `dtype` (and
    `shape`, where None entries match anything)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None:
        if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
