"""The lane-group kernels (csrc/msm.cu, the fused variant of
csrc/decompress.cu and csrc/subgroup.cu over csrc/group.cuh; csrc/pow.cu
over csrc/lanes.cuh) run on the CPU: their sources compiled by g++ through
a small CUDA shim and run with one thread per lane, __syncwarp a barrier of
the lane's group, a shuffle or a ballot an exchange through the group's
slots between two such barriers, a block of two rows at a time; group.cuh's
PTX carry chains replaced by their plain counterparts (field.cuh's f_add
and f_sub, which give the same values). The outputs
against the plain versions of the kernels' decompositions: the MSM limb
for limb with ops/curve.msm_windowed at both window widths; points and
valid flags bit for bit with ops/curve.decompress(..., y_hint=), sub_ok
with ops/curve.aggregate_subgroup_check_windowed on rows whose points all
decode and valid & sub_ok everywhere; the subgroup kernel's verdicts with
aggregate_subgroup_check_windowed and the rows' construction; the pow
kernel limb for limb with ops/cuda_field.pow_plain for both fields at
every lane-group width; at several lane-group widths, ragged point counts
and 1 to 4 rounds. This checks the kernels' scheduling and arithmetic
(units over lanes, batches, barriers, shuffles and carry lookaheads,
shared-memory layout), not the card's compiler; needs g++ with C++20."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.ops import _build, cuda_curve, cuda_field  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC, window_digits  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402

SHIM = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return uint4{a, b, c, d}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim;
void __syncwarp(unsigned);
unsigned __shfl_sync(unsigned, unsigned, int, int);
unsigned __shfl_down_sync(unsigned, unsigned, unsigned, int);
unsigned __shfl_up_sync(unsigned, unsigned, unsigned, int);
unsigned __ballot_sync(unsigned, int);
template <class T> T __ldg(const T* p) { return *p; }
inline long long clock64() { return 0; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess, cudaErrorInvalidValue, cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
       cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int*) { return 0; }
inline int cudaDeviceGetAttribute(int*, int, int) { return 0; }
template <class T> int cudaFuncSetAttribute(T*, int, int) { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
"""

HARNESS = r"""
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_shim.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim;
static thread_local std::barrier<>* group_barrier;
static thread_local uint32_t* group_slots;  // one word a lane of the group
static int group_width;
void __syncwarp(unsigned) { group_barrier->arrive_and_wait(); }
// every lane of the group posts v, then reads lane src's
static unsigned exchange(unsigned v, int src) {
  group_slots[threadIdx.x % group_width] = v;
  __syncwarp(0);
  const unsigned r = group_slots[src];
  __syncwarp(0);
  return r;
}
unsigned __shfl_sync(unsigned, unsigned v, int src, int width) { return exchange(v, src % width); }
unsigned __shfl_down_sync(unsigned, unsigned v, unsigned d, int width) {
  const int l = threadIdx.x % width;
  return exchange(v, l + (int)d < width ? l + (int)d : l);
}
unsigned __shfl_up_sync(unsigned, unsigned v, unsigned d, int width) {
  const int l = threadIdx.x % width;
  return exchange(v, l >= (int)d ? l - (int)d : l);
}
// bit (warp lane) of each lane of the group whose predicate holds
unsigned __ballot_sync(unsigned, int p) {
  const unsigned base = (threadIdx.x & 31) & ~(unsigned)(group_width - 1);
  unsigned bits = 0;
  for (int k = 0; k < group_width; k++) bits |= (exchange(p != 0, k) ? 1u : 0u) << (base + k);
  return bits;
}
alignas(16) uint32_t smem[1 << 16];
#include "msm.cu"
#include "decompress.cu"
#include "subgroup.cu"
#include "pow.cu"

template <class T> std::vector<T> readf(const char* path, size_t n) {
  std::vector<T> v(n);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n) exit(3);
  fclose(f);
  return v;
}
template <class T> void writef(const char* path, const std::vector<T>& v) {
  FILE* f = fopen(path, "wb");
  fwrite(v.data(), sizeof(T), v.size(), f);
  fclose(f);
}

// every block of `rows` rows in turn, one thread a lane, a barrier a group
template <class F> void run_blocks(int B, int lanes, int rows, F body) {
  blockDim = dim3(rows * lanes);
  group_width = lanes;
  for (int b = 0; b * rows < B; b++) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<uint32_t> slots((size_t)rows * lanes);
    for (int r = 0; r < rows; r++) bars.emplace_back(new std::barrier<>(lanes));
    std::vector<std::thread> ts;
    for (int t = 0; t < rows * lanes; t++)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        group_barrier = bars[t / lanes].get();
        group_slots = slots.data() + (size_t)(t / lanes) * lanes;
        body();
      });
    for (auto& t : ts) t.join();
  }
}

int main(int argc, char** argv) {
  const int B = atoi(argv[2]), K = atoi(argv[3]), X = atoi(argv[4]), lanes = atoi(argv[5]), rows = 2;
  if (argv[1][0] == 'm') {  // X: the window width
    auto pts = readf<int64_t>("pts.bin", (size_t)B * K * 75);
    auto sc = readf<int64_t>("sc.bin", (size_t)B * K * 17);
    std::vector<int64_t> out((size_t)B * 75);
    run_blocks(B, lanes, rows, [&] {
      if (X == 4) msm_kernel<4>(pts.data(), sc.data(), out.data(), nullptr, B, K, lanes);
      else msm_kernel<5>(pts.data(), sc.data(), out.data(), nullptr, B, K, lanes);
    });
    writef("out.bin", out);
  } else if (argv[1][0] == 's') {  // X: the rounds
    auto pts = readf<int64_t>("pts.bin", (size_t)B * K * 75);
    auto w = readf<int>("w.bin", (size_t)X * K);
    std::vector<uint8_t> ok(B);
    run_blocks(B, lanes, rows, [&] { subgroup_kernel(pts.data(), w.data(), ok.data(), nullptr, B, K, X, lanes); });
    writef("ok.bin", ok);
  } else if (argv[1][0] == 'p') {  // B elements, K: 0 Fp, 1 Fr; X: the digits
    const int L = K == 0 ? FpT::L16 : FrT::L16;
    auto x = readf<int64_t>("x.bin", (size_t)B * L);
    auto dig = readf<int>("digits.bin", (size_t)X);
    std::vector<int64_t> out((size_t)B * L, -1);
    run_blocks(B, lanes, rows, [&] {
      if (K == 0 && lanes == 2) pow_kernel<FpT, 2>(x.data(), out.data(), B, dig.data(), X);
      if (K == 0 && lanes == 4) pow_kernel<FpT, 4>(x.data(), out.data(), B, dig.data(), X);
      if (K == 1 && lanes == 2) pow_kernel<FrT, 2>(x.data(), out.data(), B, dig.data(), X);
      if (K == 1 && lanes == 4) pow_kernel<FrT, 4>(x.data(), out.data(), B, dig.data(), X);
      if (K == 1 && lanes == 8) pow_kernel<FrT, 8>(x.data(), out.data(), B, dig.data(), X);
    });
    writef("out.bin", out);
  } else {  // X: the rounds
    auto raw = readf<uint8_t>("raw.bin", (size_t)B * K * 48);
    auto hints = readf<int64_t>("hints.bin", (size_t)B * K * 25);
    auto w = readf<int>("w.bin", (size_t)X * K);
    std::vector<int64_t> pts((size_t)B * K * 75);
    std::vector<uint8_t> valid((size_t)B * K), ok(B);
    run_blocks(B, lanes, rows, [&] {
      decompress_subgroup_kernel(raw.data(), hints.data(), w.data(), pts.data(), valid.data(), ok.data(), nullptr,
                                 B, K, X, lanes);
    });
    writef("pts.bin", pts);
    writef("valid.bin", valid);
    writef("ok.bin", ok);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The simulation binary and its working directory."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the CPU simulation of the kernels")
    work = tmp_path_factory.mktemp("group_sim")
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    for name in os.listdir(csrc):
        text = open(os.path.join(csrc, name)).read()
        if name == "group.cuh":
            text = text.replace("fp_add_cc(", "f_add<FpT>(").replace("fp_sub_cc(", "f_sub<FpT>(")
        text = re.sub(r"<<<[^;]*?>>>", "", text, flags=re.S)  # launches: the harness calls the kernels
        (work / name).write_text(text)
    (work / "field_consts.cuh").write_text(_build.field_consts_header())
    (work / "cuda_shim.h").write_text(SHIM)
    (work / "sim.cpp").write_text(HARNESS)
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I.", "-include", "cuda_shim.h", "sim.cpp",
                          "-o", "sim"], cwd=work, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    return work


def _run(work, *args):
    out = subprocess.run(["./sim", *map(str, args)], cwd=work, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("B,K,wbits,lanes", [(3, 6, 5, 16), (2, 9, 4, 8), (3, 5, 5, 32), (1, 1, 4, 4)])
def test_msm_kernel_on_cpu_threads(sim, B, K, wbits, lanes):
    rng = np.random.default_rng(B * K + wbits)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=min(K, 5))] + [None]
    pts = np.stack([tc.host_point_to_mont(p) for p in host])[rng.integers(0, len(host), size=(B, K))]
    sc = np.stack([[FR_SPEC.encode(int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N) for _ in range(K)]
                   for _ in range(B)])
    sc[0, 0] = 0
    sc[-1, -1] = FR_SPEC.encode(FR_SPEC.N - 1)
    pts.astype(np.int64).tofile(sim / "pts.bin")
    sc.astype(np.int64).tofile(sim / "sc.bin")
    _run(sim, "m", B, K, wbits, lanes)
    got = np.fromfile(sim / "out.bin", np.int64).reshape(B, 3, FP_SPEC.L)
    want = tc.msm_windowed(torch.from_numpy(pts), torch.from_numpy(sc), wbits).numpy()
    assert np.array_equal(got, want)


def _encodings(B, K, seed):
    """(raw, hints, decodes) rows of honest G1 points, the identity, a point
    outside G1 and invalid encodings."""
    P = FP_SPEC.N
    x = 100
    while True:  # a valid E(Fp) point outside G1
        y = pow((x**3 + 4) % P, (P + 1) >> 2, P)
        if y * y % P == (x**3 + 4) % P and not rc.g1_in_subgroup((x, y)):
            break
        x += 1
    evil = (x, y)
    good = [rc.g1_mul(rc.G1_GEN, k) for k in (3, 5, 7)]
    rng = np.random.default_rng(seed)
    raw = np.zeros((B, K, 48), np.uint8)
    hints = np.zeros((B, K, FP_SPEC.L), np.int64)
    for b in range(B):
        for k in range(K):
            p = good[rng.integers(0, 3)] if (b + k) % 5 else None
            hint = None
            if b % 3 == 1 and k == 0:
                p = evil
            if b % 3 == 2 and k == K - 1:
                p = good[0]
                hint = p[1] + 1  # a wrong hint: invalid
            raw[b, k] = np.frombuffer(rc.g1_compress(p), np.uint8)
            hints[b, k] = FP_SPEC.encode(hint if hint is not None else p[1] if p is not None else 0)
    return raw, hints


@pytest.mark.parametrize("B,K,rounds,lanes", [(6, 10, 1, 16), (4, 7, 4, 32), (3, 5, 2, 4), (5, 3, 3, 8)])
def test_decompress_kernel_on_cpu_threads(sim, B, K, rounds, lanes):
    raw, hints = _encodings(B, K, B + K + rounds)
    w = tc.subgroup_weights(K, rounds, torch.Generator().manual_seed(K)).to(torch.int32).numpy()
    raw.tofile(sim / "raw.bin")
    hints.tofile(sim / "hints.bin")
    w.tofile(sim / "w.bin")
    _run(sim, "d", B, K, rounds, lanes)
    pts = np.fromfile(sim / "pts.bin", np.int64).reshape(B, K, 3, FP_SPEC.L)
    valid = np.fromfile(sim / "valid.bin", np.uint8).reshape(B, K).astype(bool)
    ok = np.fromfile(sim / "ok.bin", np.uint8).astype(bool)
    wp, wv, wo = cuda_curve.decompress_hinted_plain(torch.from_numpy(raw), torch.from_numpy(hints),
                                                    torch.from_numpy(w).to(torch.int64))
    assert np.array_equal(pts, wp.numpy()) and np.array_equal(valid, wv.numpy())
    rows_ok = valid.all(-1)
    assert rows_ok.any() and not rows_ok.all()
    assert np.array_equal(ok[rows_ok], wo.numpy()[rows_ok])
    assert np.array_equal(ok & rows_ok, wo.numpy() & rows_ok)
    assert (~ok[rows_ok]).any()  # a row with the point outside G1 decodes and fails


def _evil_point():
    """A valid E(Fp) point outside G1."""
    P = FP_SPEC.N
    x = 100
    while True:
        y = pow((x**3 + 4) % P, (P + 1) >> 2, P)
        if y * y % P == (x**3 + 4) % P and not rc.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


@pytest.mark.parametrize("B,K,rounds,lanes", [(4, 1, 1, 4), (5, 3, 2, 8), (4, 10, 1, 16), (3, 33, 4, 32),
                                              (4, 10, 3, 32), (3, 33, 2, 4), (5, 1, 4, 16), (4, 3, 3, 8)])
def test_subgroup_kernel_on_cpu_threads(sim, B, K, rounds, lanes):
    """Rows of honest G1 points with identities among them, and rows with
    the point outside G1, each point as another projective representative
    (sX : sY : sZ): the verdicts against the plain version of the kernel's
    decomposition and the rows' construction."""
    rng = np.random.default_rng(10 * K + rounds)
    good = [rc.g1_mul(rc.G1_GEN, int(k)) for k in rng.integers(1, 2**62, size=3)]
    kinds, host = [], []
    for b in range(B):
        row = [good[rng.integers(0, 3)] if (b + k) % 3 else None for k in range(K)]
        if b % 2 == 1:
            row[(b // 2) % K] = _evil_point()
        kinds.append(b % 2 == 0)
        host.append(row)
    pts = torch.from_numpy(np.stack([np.stack([tc.host_point_to_mont(p) for p in row]) for row in host]))
    pts = tc.fp.mul(pts, torch.from_numpy(FP_SPEC.to_mont(0xC0FFEE)))
    w = tc.subgroup_weights(K, rounds, torch.Generator().manual_seed(K + rounds)).to(torch.int32)
    pts.numpy().astype(np.int64).tofile(sim / "pts.bin")
    w.numpy().tofile(sim / "w.bin")
    _run(sim, "s", B, K, rounds, lanes)
    ok = np.fromfile(sim / "ok.bin", np.uint8).astype(bool)
    want = tc.aggregate_subgroup_check_windowed(pts, w.to(torch.int64)).numpy()
    assert np.array_equal(ok, want)
    assert ok.tolist() == kinds


@pytest.mark.parametrize("field,lanes", [("fp", 2), ("fp", 4), ("fr", 2), ("fr", 4), ("fr", 8)])
def test_pow_kernel_on_cpu_threads(sim, field, lanes):
    """The verifier's two exponents (Fp (p + 1) / 4, Fr q - 2) on a ragged
    count of elements: 0, 1 and N - 1 (canonical, in the Montgomery domain)
    and the elements whose limbs are 1 and N - 1, then random values; limb
    for limb against the plain version."""
    spec, e = (FP_SPEC, (FP_SPEC.N + 1) >> 2) if field == "fp" else (FR_SPEC, FR_SPEC.N - 2)
    rng = np.random.default_rng(lanes)
    special = [spec.to_mont(v) for v in (0, 1, spec.N - 1)] + [spec.encode(v) for v in (1, spec.N - 1)]
    rand = [spec.to_mont(int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N) for _ in range(2)]
    x = np.stack(special + rand).astype(np.int64)
    digits = np.array(window_digits(e), np.int32)
    x.tofile(sim / "x.bin")
    digits.tofile(sim / "digits.bin")
    _run(sim, "p", len(x), 0 if field == "fp" else 1, len(digits), lanes)
    got = np.fromfile(sim / "out.bin", np.int64).reshape(x.shape)
    assert np.array_equal(got, cuda_field.pow_plain(torch.from_numpy(x), spec, e).numpy())
