"""The lane-group kernels (csrc/msm.cu, the fused variant of
csrc/decompress.cu, over csrc/group.cuh) run on the CPU: their sources
compiled by g++ through a small CUDA shim and run with one thread per lane,
__syncwarp a barrier of the lane's group, a block of two rows at a time;
the PTX carry-chain adds and subtractions replaced by their plain
counterparts (field.cuh's f_add and f_sub, which give the same values).
The outputs against the plain versions of the kernels' decompositions:
the MSM limb for limb with ops/curve.msm_windowed at both window widths;
points and valid flags bit for bit with ops/curve.decompress(..., y_hint=),
sub_ok with ops/curve.aggregate_subgroup_check_windowed on rows whose
points all decode and valid & sub_ok everywhere; at several lane-group
widths, ragged point counts and 1 to 4 rounds. This checks the kernels'
scheduling (units over lanes, batches, barriers, shared-memory layout),
not the card's compiler; needs g++ with C++20."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.ops import _build, cuda_curve  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC  # noqa: E402
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
inline void __syncthreads() {}  // curve.cuh's one-thread-per-point test, not run here
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
void __syncwarp(unsigned) { group_barrier->arrive_and_wait(); }
alignas(16) uint32_t smem[1 << 16];
#include "msm.cu"
#include "decompress.cu"

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
  for (int b = 0; b * rows < B; b++) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int r = 0; r < rows; r++) bars.emplace_back(new std::barrier<>(lanes));
    std::vector<std::thread> ts;
    for (int t = 0; t < rows * lanes; t++)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        group_barrier = bars[t / lanes].get();
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
