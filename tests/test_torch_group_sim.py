"""The lane-group kernels (csrc/msm.cu, the fused variant of
csrc/decompress.cu and csrc/subgroup.cu over csrc/group.cuh; csrc/pow.cu
over csrc/lanes.cuh; the transcript kernel, csrc/blake2b.cu; the bf16 and
int8 chains, csrc/mma_chain.cu; the Montgomery-product test kernel,
csrc/field_test.cu; the prover's Fr polynomial kernels, csrc/poly.cu; the
verifier's Fr glue kernels, csrc/fr_glue.cu; the pairing kernel,
csrc/pairing.cu) run on the CPU: their sources compiled by g++ through
a small CUDA shim and run with one thread per lane, __syncwarp a barrier
of the lane's group, __syncthreads one of the block, a shuffle or a ballot
an exchange through the group's slots between two such barriers (a 64-bit
shuffle two of them), mma.sync (m16n8k16 bf16 -> f32, m16n8k16 and
m16n8k32 s8 -> s32) an exchange of every lane's fragments through the
warp's slots with the PTX ISA's fragment layouts; group.cuh's and
field_test.cu's PTX carry chains replaced by their plain counterparts
(field.cuh's f_add, f_sub and f_mul, which give the same values). The
outputs against the plain versions of the kernels' decompositions: the MSM
limb for limb with ops/curve.msm_windowed at both window widths; points
and valid flags bit for bit with ops/curve.decompress(..., y_hint=), sub_ok
with ops/curve.aggregate_subgroup_check_windowed on rows whose points all
decode and valid & sub_ok everywhere; the subgroup kernel's verdicts with
aggregate_subgroup_check_windowed and the rows' construction; the pow
kernel limb for limb with ops/cuda_field.pow_plain for both fields at
ragged element counts; each kernel at the lanes its launcher fixes,
ragged point counts and 1 to 4 rounds; the transcript kernel word for
word with cuda_blake.transcript_hashes_plain, ragged rows, one squeeze,
more squeezes than a row has groups, the rows' bytes staged in shared
memory and read from global memory; both chains with
cuda_mma.chain_plain at ragged batch widths and 0, 1 and 7 steps; the
Montgomery-product kernel with cuda_field.mont_mul_plain for both fields
at ragged counts, one and several blocks, the slabs 0 or 8 bytes past a
16-byte boundary; the poly kernels through their host entry points
(ph2_fr_ntt and the three elementwise ones, each launch a grid of CPU
threads at the launch's own geometry: bit reversal, powers tables,
twiddles, one launch a stage) word for word with ops/poly.py's plain
versions at sizes from 1 to 2^12 and ragged lengths; the pairing kernel's
verdicts on true, false and identity rows, rows ragged against the rows
per block, and its stage count against
pairing_program's critical path (its carry chain in plain C); the Fr glue through
its entry point on ops/cuda_fr.layout's geometry limb for limb with
ops/limb.py's mont_mul, add, sub, sum_lazy and dot_lazy (broadcast and
strided operands, ragged counts in one and several blocks, the domain's
edges); the mma emulations themselves with a numpy product.
This checks the kernels' scheduling and arithmetic (units over lanes,
batches, barriers, shuffles and carry lookaheads, shared-memory layout),
not the card's compiler; needs g++ with C++20."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.ops import _build, cuda_blake, cuda_curve, cuda_field, cuda_fr, cuda_mma, cuda_poly  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_pairing, limb, pairing_program  # noqa: E402
from plutus_halo2_tpu_torch.ops import pairing as tp  # noqa: E402
from plutus_halo2_tpu_torch.ops import poly as tpoly  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC, window_digits  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402

SHIM = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>
#define PH2_CPU_SIM
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
void __syncthreads();
unsigned __shfl_sync(unsigned, unsigned, int, int);
unsigned long __shfl_sync(unsigned, unsigned long, int, int);
unsigned long long __shfl_sync(unsigned, unsigned long long, int, int);
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
inline float __int2float_rn(int v) { return (float)v; }
inline int __float2int_rz(float v) { return (int)v; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; i++) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (unsigned long long)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; i++) r |= (unsigned)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xff) << (8 * i);
  return r;
}
"""

HARNESS = r"""
#include <algorithm>
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
static thread_local std::barrier<>* block_barrier;
static thread_local uint32_t* group_slots;  // one word a lane of the group
static thread_local uint32_t* group_frags;  // six words a lane of the group: mma fragments
static int group_width;
void __syncwarp(unsigned) { group_barrier->arrive_and_wait(); }
void __syncthreads() { block_barrier->arrive_and_wait(); }
// every lane of the group posts v, then reads lane src's
static unsigned exchange(unsigned v, int src) {
  group_slots[threadIdx.x % group_width] = v;
  __syncwarp(0);
  const unsigned r = group_slots[src];
  __syncwarp(0);
  return r;
}
unsigned __shfl_sync(unsigned, unsigned v, int src, int width) { return exchange(v, src % width); }
template <class U> static U shfl64(U v, int src, int width) {
  const U lo = __shfl_sync(0, (unsigned)v, src, width), hi = __shfl_sync(0, (unsigned)(v >> 32), src, width);
  return lo | hi << 32;
}
unsigned long __shfl_sync(unsigned, unsigned long v, int src, int width) { return shfl64(v, src, width); }
unsigned long long __shfl_sync(unsigned, unsigned long long v, int src, int width) { return shfl64(v, src, width); }
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
static float bf16_half(uint32_t r, int h) { return __uint_as_float(h ? r & 0xffff0000u : r << 16); }
// d += a . b over the warp (group_width 32): every lane posts its A and B
// fragments; each then forms its four sums, A[row][k] from lane
// (row % 8) 4 + (k % 8) / 2, register row / 8 + 2 (k / 8), half k % 2, and
// B[k][n] from lane 4 n + (k % 8) / 2, register k / 8, half k % 2
void mma_bf16_m16n8k16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  uint32_t* f = group_frags + 6 * lane;
  for (int i = 0; i < 4; i++) f[i] = a[i];
  for (int i = 0; i < 2; i++) f[4 + i] = b[i];
  __syncwarp(0);
  for (int i = 0; i < 4; i++) {
    const int row = g + 8 * (i >> 1), col = 2 * q + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; k++) {
      const float x = bf16_half(group_frags[6 * ((row % 8) * 4 + (k % 8) / 2) + row / 8 + 2 * (k / 8)], k % 2);
      const float y = bf16_half(group_frags[6 * (col * 4 + (k % 8) / 2) + 4 + k / 8], k % 2);
      s += x * y;
    }
    d[i] = s;
  }
  __syncwarp(0);
}
static int s8_at(uint32_t r, int k) { return (int8_t)(r >> (8 * (k % 4))); }
// d += a . b over the warp (group_width 32), s8 fragments of depth K (16 or
// 32): every lane posts its K / 8 A and K / 16 B registers; each then forms
// its four sums, A[row][k] from lane (row % 8) 4 + (k % 16) / 4, register
// row / 8 + 2 (k / 16), byte k % 4, and B[k][n] from lane 4 n + (k % 16) / 4,
// register k / 16, byte k % 4
static void mma_s8(int (&d)[4], const uint32_t* a, const uint32_t* b, int K) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  uint32_t* f = group_frags + 6 * lane;
  for (int i = 0; i < K / 8; i++) f[i] = a[i];
  for (int i = 0; i < K / 16; i++) f[4 + i] = b[i];
  __syncwarp(0);
  for (int i = 0; i < 4; i++) {
    const int row = g + 8 * (i >> 1), col = 2 * q + (i & 1);
    int s = d[i];
    for (int k = 0; k < K; k++)
      s += s8_at(group_frags[6 * ((row % 8) * 4 + (k % 16) / 4) + row / 8 + 2 * (k / 16)], k) *
           s8_at(group_frags[6 * (col * 4 + (k % 16) / 4) + 4 + k / 16], k);
    d[i] = s;
  }
  __syncwarp(0);
}
void mma_s8_m16n8k32(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) { mma_s8(d, a, b, 32); }
void mma_s8_m16n8k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b) { mma_s8(d, a, &b, 16); }
alignas(16) uint32_t smem[1 << 16];
#include "msm.cu"
#include "decompress.cu"
#include "subgroup.cu"
#include "pow.cu"
#include "blake2b.cu"
#include "mma_chain.cu"
#include "field_test.cu"
// poly.cu's launches, each a grid of CPU threads (defined below run_grid)
template <class F> void sim_launch(unsigned blocks, int threads, F body);
#include "poly.cu"
#include "fr_glue.cu"
#include "pairing.cu"

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

// every block in turn, one thread a lane, a barrier a group of `width`
// lanes and one the block
template <class F> void run_grid(int blocks, int threads, int width, F body) {
  blockDim = dim3(threads);
  group_width = width;
  for (int b = 0; b < blocks; b++) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::barrier<> block(threads);
    std::vector<uint32_t> slots((size_t)threads), frags((size_t)threads * 6);
    for (int r = 0; r < threads / width; r++) bars.emplace_back(new std::barrier<>(width));
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; t++)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        group_barrier = bars[t / width].get();
        block_barrier = &block;
        group_slots = slots.data() + (size_t)(t / width) * width;
        group_frags = frags.data() + (size_t)(t / width) * width * 6;
        body();
      });
    for (auto& t : ts) t.join();
  }
}

template <class F> void sim_launch(unsigned blocks, int threads, F body) { run_grid((int)blocks, threads, 32, body); }

// blocks of `rows` rows of `lanes` lanes
template <class F> void run_blocks(int B, int lanes, int rows, F body) {
  run_grid((B + rows - 1) / rows, rows * lanes, lanes, body);
}

int main(int argc, char** argv) {
  if (argv[1][0] == 't') {  // B rows of T bytes, S squeezes; rows a block, groups a row, staged
    const int B = atoi(argv[2]), T = atoi(argv[3]), S = atoi(argv[4]), rows = atoi(argv[5]), groups = atoi(argv[6]),
              off = atoi(argv[7]);
    const bool staged = atoi(argv[8]) != 0;
    auto raw = readf<uint8_t>("buf.bin", (size_t)B * T);
    alignas(16) static uint8_t store[1 << 16];  // the rows from `off` bytes past a 16-byte boundary
    memcpy(store + off, raw.data(), raw.size());
    const uint8_t* buf = store + off;
    auto lens = readf<int>("lens.bin", (size_t)2 * S);  // and the squeezes by final block
    int max_fb = 0;
    for (int s = 0; s < S; s++) max_fb = std::max(max_fb, (lens[s] - 1) / 128);
    std::vector<int64_t> h1((size_t)B * S * 8, -1), h2((size_t)B * S * 8, -1);
    const int threads = (rows * groups * B2_LANES + 31) / 32 * 32;
    run_grid((B + rows - 1) / rows, threads, B2_LANES, [&] {
      auto kernel = staged ? transcript_kernel<B2_LANES, true> : transcript_kernel<B2_LANES, false>;
      kernel(buf, B, T, lens.data(), S, max_fb, rows, groups, h1.data(), h2.data());
    });
    writef("h1.bin", h1);
    writef("h2.bin", h2);
    return 0;
  }
  if (argv[1][0] == 'c') {  // B columns, steps
    const int B = atoi(argv[2]), steps = atoi(argv[3]);
    auto mat = readf<int8_t>("mat.bin", 96 * 48);
    auto vec = readf<int8_t>("vec.bin", (size_t)48 * B);
    std::vector<int32_t> out((size_t)48 * B, -1);
    run_grid(((B + 15) / 16 + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32, 32,
             [&] { bf16_chain_kernel(mat.data(), vec.data(), out.data(), B, steps); });
    writef("out.bin", out);
    return 0;
  }
  if (argv[1][0] == 'i') {  // B columns, steps; one warp a block
    const int B = atoi(argv[2]), steps = atoi(argv[3]);
    auto mat = readf<int8_t>("mat.bin", 96 * 48);
    auto vec = readf<int8_t>("vec.bin", (size_t)48 * B);
    std::vector<int32_t> out((size_t)48 * B, -1);
    run_grid((B + 15) / 16, 32, 32, [&] { int8_chain_kernel(mat.data(), vec.data(), out.data(), B, steps); });
    writef("out.bin", out);
    return 0;
  }
  if (argv[1][0] == 'y') {  // one s8 product of depth K (16 or 32) from every lane's fragments
    const int K = atoi(argv[2]);
    auto frag = readf<uint32_t>("frag.bin", 32 * 6);
    auto acc = readf<int32_t>("acc.bin", 32 * 4);
    run_grid(1, 32, 32, [&] {
      const int l = threadIdx.x;
      uint32_t a[4] = {frag[6 * l], frag[6 * l + 1], frag[6 * l + 2], frag[6 * l + 3]};
      uint32_t b[2] = {frag[6 * l + 4], frag[6 * l + 5]};
      int d[4] = {acc[4 * l], acc[4 * l + 1], acc[4 * l + 2], acc[4 * l + 3]};
      if (K == 32) mma_s8_m16n8k32(d, a, b);
      else mma_s8_m16n8k16(d, reinterpret_cast<uint32_t(&)[2]>(a), b[0]);
      for (int i = 0; i < 4; i++) acc[4 * l + i] = d[i];
    });
    writef("acc.bin", acc);
    return 0;
  }
  if (argv[1][0] == 'f') {  // n elements, 0 Fp or 1 Fr; a's, b's and out's first words
    // 0 or 1 words past a 16-byte boundary
    const int n = atoi(argv[2]), fr = atoi(argv[3]), threads = MONT_MUL_THREADS;
    const int off[3] = {atoi(argv[4]), atoi(argv[5]), atoi(argv[6])};
    const size_t words = (size_t)n * (fr ? FrT::L16 : FpT::L16);
    std::vector<int64_t> slab[3];
    for (int i = 0; i < 3; i++) slab[i].assign(words + 4, -7);  // a sentinel around the rows
    int64_t* p[3];
    for (int i = 0; i < 3; i++) {
      p[i] = slab[i].data() + off[i];
      while ((reinterpret_cast<uintptr_t>(p[i]) & 15) != 8u * off[i]) p[i]++;
    }
    auto a = readf<int64_t>("a.bin", words), b = readf<int64_t>("b.bin", words);
    std::copy(a.begin(), a.end(), p[0]);
    std::copy(b.begin(), b.end(), p[1]);
    run_grid((n + threads - 1) / threads, threads, 32, [&] {
      if (fr) mont_mul_kernel<FrT>(p[0], p[1], p[2], n);
      else mont_mul_kernel<FpT>(p[0], p[1], p[2], n);
    });
    std::vector<int64_t> out(p[2], p[2] + words);
    for (int64_t* q = slab[2].data(); q < slab[2].data() + slab[2].size(); q++)
      if ((q < p[2] || q >= p[2] + words) && *q != -7) return 4;  // a word outside the rows written
    writef("out.bin", out);
    return 0;
  }
  if (argv[1][0] == 'g') {  // the Fr glue: op; a's and b's words and first-limb offsets
    const int op = atoi(argv[2]);
    const size_t na = atol(argv[3]), oa = atol(argv[4]), nb = atol(argv[5]), ob = atol(argv[6]);
    auto a = readf<int64_t>("a.bin", na), b = readf<int64_t>("b.bin", nb);
    auto geom = readf<int64_t>("geom.bin", 12);
    std::vector<int64_t> out((size_t)geom[0] * FrT::L16 + 1, -7);  // a sentinel past the rows
    if (ph2_fr_glue(op, a.data() + oa, b.data() + ob, out.data(), geom.data(), nullptr)) return 5;
    if (out.back() != -7) return 4;
    out.pop_back();
    writef("out.bin", out);
    return 0;
  }
  if (argv[1][0] == 'q') {  // the pairing kernel: B rows, rows a block, row slots, table and ladder words
    const int B = atoi(argv[2]), rows = atoi(argv[3]), row_slots = atoi(argv[4]), tab_words = atoi(argv[5]),
              line_words = atoi(argv[6]);
    auto el = readf<int64_t>("el.bin", (size_t)B * 75), er = readf<int64_t>("er.bin", (size_t)B * 75);
    auto lines = readf<uint32_t>("lines.bin", line_words);
    auto tab = readf<int>("tab.bin", tab_words);
    auto consts = readf<uint32_t>("consts.bin", (size_t)12 * PAIR_N_CONST);
    std::vector<int> out(B, -1);
    std::vector<long long> ph((size_t)B * 10, 0);
    run_blocks(B, PAIR_LANES, rows, [&] {
      pairing_kernel<PAIR_LANES>(el.data(), er.data(), lines.data(), tab.data(), consts.data(), out.data(), ph.data(),
                                 nullptr, B, row_slots, tab_words);
    });
    writef("out.bin", out);
    writef("ph.bin", ph);
    return 0;
  }
  if (argv[1][0] == 'x') {  // one m16n8k16 product from every lane's fragments
    auto frag = readf<uint32_t>("frag.bin", 32 * 6);
    auto acc = readf<float>("acc.bin", 32 * 4);
    run_grid(1, 32, 32, [&] {
      const int l = threadIdx.x;
      uint32_t a[4] = {frag[6 * l], frag[6 * l + 1], frag[6 * l + 2], frag[6 * l + 3]};
      uint32_t b[2] = {frag[6 * l + 4], frag[6 * l + 5]};
      float d[4] = {acc[4 * l], acc[4 * l + 1], acc[4 * l + 2], acc[4 * l + 3]};
      mma_bf16_m16n8k16(d, a, b);
      for (int i = 0; i < 4; i++) acc[4 * l + i] = d[i];
    });
    writef("acc.bin", acc);
    return 0;
  }
  if (argv[1][0] == 'n' || argv[1][0] == 'e') {  // n, slo, shi; n: lg; e: the op (0 mul, 1 scale, 2 powers)
    const int64_t n = atoll(argv[2]);
    const int slo = atoi(argv[3]), shi = atoi(argv[4]), x = atoi(argv[5]);
    auto a = readf<uint32_t>("a.bin", (size_t)n * 8);
    auto bp = readf<uint32_t>("bp.bin", (size_t)std::max(slo + shi, 1) * 8);
    std::vector<uint32_t> out((size_t)n * 8, 0xdeadbeefu), lo((size_t)8 << slo), hi((size_t)8 << shi);
    std::vector<uint32_t> tw((size_t)std::max<int64_t>(n / 2, 1) * 8);
    int rc;
    if (argv[1][0] == 'n') {
      rc = ph2_fr_ntt(a.data(), out.data(), n, x, bp.data(), slo, shi, lo.data(), hi.data(), tw.data(), nullptr);
    } else if (x == 0) {
      auto b = readf<uint32_t>("b.bin", (size_t)n * 8);
      rc = ph2_fr_mul_array(a.data(), b.data(), out.data(), n, nullptr);
    } else if (x == 1) {
      rc = ph2_fr_scale_array(a.data(), bp.data(), out.data(), n, nullptr);
    } else {
      rc = ph2_fr_powers_mul_array(a.data(), out.data(), n, bp.data(), slo, shi, lo.data(), hi.data(), nullptr);
    }
    if (rc) return 5;
    writef("out.bin", out);
    return 0;
  }
  const int B = atoi(argv[2]), K = atoi(argv[3]), X = atoi(argv[4]), rows = 2;
  if (argv[1][0] == 'm') {  // X: the window width
    auto pts = readf<int64_t>("pts.bin", (size_t)B * K * 75);
    auto sc = readf<int64_t>("sc.bin", (size_t)B * K * 17);
    std::vector<int64_t> out((size_t)B * 75);
    run_blocks(B, MSM_LANES, rows, [&] {
      if (X == 4) msm_kernel<4>(pts.data(), sc.data(), out.data(), nullptr, B, K, MSM_LANES);
      else msm_kernel<5>(pts.data(), sc.data(), out.data(), nullptr, B, K, MSM_LANES);
    });
    writef("out.bin", out);
  } else if (argv[1][0] == 's') {  // X: the rounds
    auto pts = readf<int64_t>("pts.bin", (size_t)B * K * 75);
    auto w = readf<int>("w.bin", (size_t)X * K);
    std::vector<uint8_t> ok(B);
    run_blocks(B, SUBGROUP_LANES, rows,
               [&] { subgroup_kernel(pts.data(), w.data(), ok.data(), nullptr, B, K, X, SUBGROUP_LANES); });
    writef("ok.bin", ok);
  } else if (argv[1][0] == 'p') {  // B elements, K: 0 Fp, 1 Fr; X: the digits
    const int L = K == 0 ? FpT::L16 : FrT::L16;
    auto x = readf<int64_t>("x.bin", (size_t)B * L);
    auto dig = readf<int>("digits.bin", (size_t)X);
    std::vector<int64_t> out((size_t)B * L, -1);
    run_blocks(B, POW_LANES, POW_ROWS, [&] {
      if (K == 0) pow_kernel<FpT, POW_LANES>(x.data(), out.data(), B, dig.data(), X);
      else pow_kernel<FrT, POW_LANES>(x.data(), out.data(), B, dig.data(), X);
    });
    writef("out.bin", out);
  } else {  // X: the rounds
    auto raw = readf<uint8_t>("raw.bin", (size_t)B * K * 48);
    auto hints = readf<int64_t>("hints.bin", (size_t)B * K * 25);
    auto w = readf<int>("w.bin", (size_t)X * K);
    std::vector<int64_t> pts((size_t)B * K * 75);
    std::vector<uint8_t> valid((size_t)B * K), ok(B);
    run_blocks(B, DECOMPRESS_LANES, rows, [&] {
      decompress_subgroup_kernel(raw.data(), hints.data(), w.data(), pts.data(), valid.data(), ok.data(), nullptr,
                                 B, K, X, DECOMPRESS_LANES);
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
        if name in ("group.cuh", "field_test.cu"):
            text = text.replace("fp_add_cc(", "f_add<FpT>(").replace("fp_sub_cc(", "f_sub<FpT>(")
            text = text.replace("fp_mul_cc(", "f_mul<FpT>(")
        if name in ("poly.cu", "fr_glue.cu"):  # host entry points run: each launch a grid of CPU threads
            text = re.sub(r"(\w+)<<<(.*?), (\w+), 0, [^;]*?>>>\((.*?)\);", r"sim_launch(\2, \3, [&] { \1(\4); });",
                          text, flags=re.S)
        text = re.sub(r"<<<[^;]*?>>>", "", text, flags=re.S)  # launches: the harness calls the kernels
        (work / name).write_text(text)
    (work / "field_consts.cuh").write_text(_build.field_consts_header())
    (work / "cuda_runtime.h").write_text("#pragma once\n")  # the shim stands in for it
    (work / "cuda_shim.h").write_text(SHIM)
    (work / "sim.cpp").write_text(HARNESS)
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I.", "-include", "cuda_shim.h", "sim.cpp",
                          "-o", "sim"], cwd=work, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    return work


def _run(work, *args):
    out = subprocess.run(["./sim", *map(str, args)], cwd=work, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("B,K,wbits", [(3, 6, 5), (2, 9, 4), (3, 5, 5), (1, 1, 4), (1, 36, 5)])
def test_msm_kernel_on_cpu_threads(sim, B, K, wbits):
    rng = np.random.default_rng(B * K + wbits)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=min(K, 5))] + [None]
    pts = np.stack([tc.host_point_to_mont(p) for p in host])[rng.integers(0, len(host), size=(B, K))]
    sc = np.stack([[FR_SPEC.encode(int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N) for _ in range(K)]
                   for _ in range(B)])
    sc[0, 0] = 0
    sc[-1, -1] = FR_SPEC.encode(FR_SPEC.N - 1)
    pts.astype(np.int64).tofile(sim / "pts.bin")
    sc.astype(np.int64).tofile(sim / "sc.bin")
    _run(sim, "m", B, K, wbits)
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


@pytest.mark.parametrize("B,K,rounds", [(6, 10, 1), (4, 7, 4), (3, 5, 2), (5, 3, 3)])
def test_decompress_kernel_on_cpu_threads(sim, B, K, rounds):
    raw, hints = _encodings(B, K, B + K + rounds)
    w = tc.subgroup_weights(K, rounds, torch.Generator().manual_seed(K)).to(torch.int32).numpy()
    raw.tofile(sim / "raw.bin")
    hints.tofile(sim / "hints.bin")
    w.tofile(sim / "w.bin")
    _run(sim, "d", B, K, rounds)
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


@pytest.mark.parametrize("B,K,rounds", [(4, 1, 1), (5, 3, 2), (4, 10, 1), (3, 33, 4), (4, 10, 3), (3, 33, 2),
                                        (5, 1, 4), (4, 3, 3)])
def test_subgroup_kernel_on_cpu_threads(sim, B, K, rounds):
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
    _run(sim, "s", B, K, rounds)
    ok = np.fromfile(sim / "ok.bin", np.uint8).astype(bool)
    want = tc.aggregate_subgroup_check_windowed(pts, w.to(torch.int64)).numpy()
    assert np.array_equal(ok, want)
    assert ok.tolist() == kinds


@pytest.mark.parametrize("field,n", [("fp", 7), ("fp", 17), ("fr", 5), ("fr", 13), ("fr", 26)])
def test_pow_kernel_on_cpu_threads(sim, field, n):
    """The verifier's two exponents (Fp (p + 1) / 4, Fr q - 2) on n
    elements, ragged against the launcher's elements a block, in one and
    in several blocks: 0, 1 and N - 1 (canonical, in the Montgomery domain)
    and the elements whose limbs are 1 and N - 1, then random values; limb
    for limb against the plain version."""
    spec, e = (FP_SPEC, (FP_SPEC.N + 1) >> 2) if field == "fp" else (FR_SPEC, FR_SPEC.N - 2)
    rng = np.random.default_rng(n)
    special = [spec.to_mont(v) for v in (0, 1, spec.N - 1)] + [spec.encode(v) for v in (1, spec.N - 1)]
    rand = [spec.to_mont(int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N) for _ in range(n)]
    x = np.stack((special + rand)[:n]).astype(np.int64)
    digits = np.array(window_digits(e), np.int32)
    x.tofile(sim / "x.bin")
    digits.tofile(sim / "digits.bin")
    _run(sim, "p", len(x), 0 if field == "fp" else 1, len(digits))
    got = np.fromfile(sim / "out.bin", np.int64).reshape(x.shape)
    assert np.array_equal(got, cuda_field.pow_plain(torch.from_numpy(x), spec, e).numpy())


SIMPLE_MUL_LENGTHS = (264, 265, 266, 463, 562, 1124, 1125, 1175, 1275)  # models/layout.py


@pytest.mark.parametrize("lengths,B,rows,groups,staged", [
    (SIMPLE_MUL_LENGTHS, 5, 2, 9, 1),
    (SIMPLE_MUL_LENGTHS, 1, 1, 9, 1),
    ((1, 128, 129, 300, 1275), 5, 2, 5, 1),
    ((1, 128, 129, 300, 1275), 1, 1, 5, 1),
    ((200,), 5, 2, 1, 1),               # one squeeze
    (SIMPLE_MUL_LENGTHS, 5, 2, 4, 1),   # more squeezes than groups: 3 rounds
    ((1, 128, 129, 300, 1275), 5, 3, 2, 1),
    # unstaged: every block read from global memory (rows too long to stage)
    (SIMPLE_MUL_LENGTHS, 5, 2, 9, 0),
    ((1275, 1, 300, 129, 128), 4, 3, 2, 0),  # unsorted lengths, rounds
    ((1, 128, 129, 300, 1275), 1, 1, 5, 0),
])
def test_transcript_kernel_on_cpu_threads(sim, lengths, B, rows, groups, staged):
    """Word for word against the plain Blake2b, the rows' bytes staged in
    shared memory or read from global memory; rows of T bytes with T
    below, at and above the staged blocks' length (bytes past a squeeze are
    random, so the final block's masking shows), the buffer 0 to 6 bytes
    past a 16-byte boundary (the staging's unaligned ends)."""
    T = max(lengths) + B % 3 - 1
    rng = np.random.default_rng(B * 31 + rows + groups + 100 * staged)
    buf = rng.integers(0, 256, size=(B, T), dtype=np.uint8)
    buf.tofile(sim / "buf.bin")
    order = sorted(range(len(lengths)), key=lambda s: ((lengths[s] - 1) // 128, s))
    np.array(lengths + tuple(order), np.int32).tofile(sim / "lens.bin")
    _run(sim, "t", B, T, len(lengths), rows, groups, (B + groups) % 7, staged)
    got = [np.fromfile(sim / f"h{i}.bin", np.int64).reshape(B, len(lengths), 8) for i in (1, 2)]
    want = cuda_blake.transcript_hashes_plain(torch.from_numpy(buf), list(lengths))
    assert np.array_equal(got[0], want[0].numpy()) and np.array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("B,steps", [(1, 0), (1, 7), (17, 1), (17, 7), (40, 0), (40, 7), (40, 1)])
def test_bf16_chain_kernel_on_cpu_threads(sim, B, steps):
    """The chain in mma.sync registers, bit for bit against the exact plain
    chain, on the JAX probe's kind of inputs with a negative entry in each
    operand; ragged last warps and blocks."""
    rng = np.random.default_rng(B + steps)
    mat = rng.integers(0, 127, (96, 48)).astype(np.int8)
    vec = rng.integers(0, 127, (48, B)).astype(np.int8)
    mat[5, 7], vec[3, 0] = -100, -128
    mat.tofile(sim / "mat.bin")
    vec.tofile(sim / "vec.bin")
    _run(sim, "c", B, steps)
    got = np.fromfile(sim / "out.bin", np.int32).reshape(48, B)
    want = cuda_mma.chain_plain(torch.from_numpy(mat), torch.from_numpy(vec), steps).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("B,steps", [(1, 0), (1, 7), (17, 1), (17, 7), (40, 0), (40, 1), (40, 7)])
def test_int8_chain_kernel_on_cpu_threads(sim, B, steps):
    """The int8 chain in mma.sync s8 registers, in the lane permutation of
    its accumulators, bit for bit against the exact plain chain, with a
    negative entry in each operand (read as signed bytes, masked by its
    two's complement, returned sign-extended at 0 steps); a ragged last
    warp."""
    rng = np.random.default_rng(100 + B + steps)
    mat = rng.integers(0, 127, (96, 48)).astype(np.int8)
    vec = rng.integers(0, 127, (48, B)).astype(np.int8)
    mat[5, 7], vec[3, 0] = -100, -128
    mat.tofile(sim / "mat.bin")
    vec.tofile(sim / "vec.bin")
    _run(sim, "i", B, steps)
    got = np.fromfile(sim / "out.bin", np.int32).reshape(48, B)
    want = cuda_mma.chain_plain(torch.from_numpy(mat), torch.from_numpy(vec), steps).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("field,n,offsets", [
    ("fp", 1, (0, 0, 0)), ("fp", 255, (1, 0, 1)), ("fp", 129, (0, 1, 0)), ("fp", 300, (1, 1, 1)),
    ("fr", 1, (1, 1, 0)), ("fr", 127, (0, 0, 1)), ("fr", 257, (1, 0, 0)), ("fr", 172, (0, 1, 1)),
])
def test_mont_mul_kernel_on_cpu_threads(sim, field, n, offsets):
    """The Montgomery-product test kernel (two CIOS products an element,
    rows staged through shared memory with 16-byte accesses) limb for limb
    against the plain product: ragged counts in one and several blocks,
    each slab 0 or 8 bytes past a 16-byte boundary, no word written outside
    the output's rows; 0, 1 and N - 1 among the inputs, as limbs and in
    the Montgomery domain."""
    spec = FP_SPEC if field == "fp" else FR_SPEC
    rng = np.random.default_rng(n)
    edge = [spec.encode(v) for v in (0, 1, spec.N - 1)] + [spec.to_mont(v) for v in (1, spec.N - 1)]
    rand = [spec.encode(int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N) for _ in range(n)]
    a = np.stack((edge + rand)[:n]).astype(np.int64)
    b = np.stack((rand[::-1] + edge)[:n]).astype(np.int64)
    if n > len(edge):
        b[len(edge) : 2 * len(edge)] = edge  # every edge value times every other
    a.tofile(sim / "a.bin")
    b.tofile(sim / "b.bin")
    _run(sim, "f", n, 0 if field == "fp" else 1, *offsets)
    got = np.fromfile(sim / "out.bin", np.int64).reshape(n, spec.L)
    assert np.array_equal(got, cuda_field.mont_mul_plain(torch.from_numpy(a), torch.from_numpy(b), spec).numpy())


def _bf16_bits(x):
    """float32 values exact in bf16 -> their 16-bit patterns."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any()
    return (bits >> 16).astype(np.uint32)


def test_mma_emulation_against_numpy(sim):
    """The simulation's mma.sync m16n8k16 against a numpy product: A (16 x
    16) and B (16 x 8) of values exact in bf16, packed into the lanes'
    fragments as the PTX ISA lays them out (g = lane / 4, q = lane % 4: A
    registers (g, 2q..), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..); B (2q.., g),
    (2q+8.., g); the lower column or row in the low half), C and D likewise
    ((g, 2q..), (g+8, 2q..)); every sum is exact in f32."""
    rng = np.random.default_rng(3)
    A = rng.integers(-128, 129, (16, 16)) / 4.0
    Bm = rng.integers(-128, 129, (16, 8)) / 2.0
    C = rng.integers(-1000, 1000, (16, 8)).astype(np.float64)
    a16, b16 = _bf16_bits(A), _bf16_bits(Bm)
    frag = np.zeros((32, 6), np.uint32)
    acc = np.zeros((32, 4), np.float32)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for i, (r, c) in enumerate(((g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8), (g + 8, 2 * q + 8))):
            frag[lane, i] = a16[r, c] | a16[r, c + 1] << 16
        for i, k in enumerate((2 * q, 2 * q + 8)):
            frag[lane, 4 + i] = b16[k, g] | b16[k + 1, g] << 16
        acc[lane] = [C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q], C[g + 8, 2 * q + 1]]
    frag.tofile(sim / "frag.bin")
    acc.tofile(sim / "acc.bin")
    _run(sim, "x")
    d = np.fromfile(sim / "acc.bin", np.float32).reshape(32, 4)
    got = np.zeros((16, 8))
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        got[g, 2 * q : 2 * q + 2], got[g + 8, 2 * q : 2 * q + 2] = d[lane, :2], d[lane, 2:]
    assert np.array_equal(got, A @ Bm + C)


@pytest.mark.parametrize("K", [16, 32])
def test_mma_s8_emulation_against_numpy(sim, K):
    """The simulation's mma.sync m16n8k16 and m16n8k32 s8 -> s32 against a
    numpy product: signed bytes A (16 x K) and B (K x 8) packed into the
    lanes' fragments as the PTX ISA lays them out (g = lane / 4, q = lane %
    4; 4 k-consecutive bytes a register, the lowest k in the low byte: A
    registers (g, 4q..), (g+8, 4q..), and for K = 32 (g, 16+4q..), (g+8,
    16+4q..); B (4q.., g), and for K = 32 (16+4q.., g)), C and D as int32
    (g, 2q..), (g+8, 2q..)."""
    rng = np.random.default_rng(K)
    A = rng.integers(-128, 128, (16, K))
    Bm = rng.integers(-128, 128, (K, 8))
    C = rng.integers(-10**6, 10**6, (16, 8))
    byte = lambda x: int(x) & 0xFF  # noqa: E731
    frag = np.zeros((32, 6), np.uint32)
    acc = np.zeros((32, 4), np.int32)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for j in range(K // 8):  # a0 (g, k0..), a1 (g + 8, k0..), k0 = 4q (+16 for a2, a3)
            r, k0 = g + 8 * (j % 2), 4 * q + 16 * (j // 2)
            frag[lane, j] = sum(byte(A[r, k0 + i]) << (8 * i) for i in range(4))
        for j in range(K // 16):
            frag[lane, 4 + j] = sum(byte(Bm[4 * q + 16 * j + i, g]) << (8 * i) for i in range(4))
        acc[lane] = [C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q], C[g + 8, 2 * q + 1]]
    frag.tofile(sim / "frag.bin")
    acc.tofile(sim / "acc.bin")
    _run(sim, "y", K)
    d = np.fromfile(sim / "acc.bin", np.int32).reshape(32, 4)
    got = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        got[g, 2 * q : 2 * q + 2], got[g + 8, 2 * q : 2 * q + 2] = d[lane, :2], d[lane, 2:]
    assert np.array_equal(got, A @ Bm + C)


def _poly_words(n, seed):
    from plutus_halo2_tpu_torch.refimpl.field import Q

    rng = np.random.default_rng(seed)
    vals = [Q - 1, 0, 1] + [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(max(n - 3, 0))]
    return tpoly.to_words(vals[:n], "cpu")


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("lg", [0, 1, 2, 3, 5, 8, 12])
def test_poly_ntt_on_cpu_threads(sim, lg):
    """ph2_fr_ntt's launches (bit reversal over lg bits, the powers tables
    of omega split at slo, the twiddle table, a launch a stage with
    i0 = (t >> s) << (s + 1) | j and the twiddle at j << (lg - 1 - s)) word
    for word against the plain NTT, with the wrapper's own table split."""
    from plutus_halo2_tpu_torch.refimpl.poly import domain_omega

    n, w = 1 << lg, domain_omega(lg)
    a = _poly_words(n, lg)
    slo, shi = cuda_poly._split(max(lg - 1, 0))
    _u32(a).tofile(sim / "a.bin")
    _u32(cuda_poly._bit_powers(w, slo + shi, "cpu")).tofile(sim / "bp.bin")
    _run(sim, "n", n, slo, shi, lg)
    got = np.fromfile(sim / "out.bin", np.uint32).reshape(n, 8)
    assert np.array_equal(got, _u32(tpoly.ntt_plain(a, w)))


@pytest.mark.parametrize("n", [1, 2, 255, 257, 1000])
@pytest.mark.parametrize("op", ["mul", "scale", "powers_mul"])
def test_poly_elementwise_on_cpu_threads(sim, op, n):
    from plutus_halo2_tpu_torch.refimpl.field import Q

    a, b = _poly_words(n, n), _poly_words(n, n + 1).flip(0).contiguous()
    k = 0xC0FFEE ** 9 % Q
    _u32(a).tofile(sim / "a.bin")
    if op == "mul":
        _u32(b).tofile(sim / "b.bin")
        np.zeros(8, np.uint32).tofile(sim / "bp.bin")
        _run(sim, "e", n, 0, 0, 0)
        want = tpoly.mul_array_plain(a, b)
    elif op == "scale":
        _u32(cuda_poly._bit_powers(k, 1, "cpu")).tofile(sim / "bp.bin")  # k R mod q
        _run(sim, "e", n, 0, 0, 1)
        want = tpoly.scale_array_plain(a, k)
    else:
        slo, shi = cuda_poly._split(max(n - 1, 0).bit_length())
        _u32(cuda_poly._bit_powers(k, slo + shi, "cpu")).tofile(sim / "bp.bin")
        _run(sim, "e", n, slo, shi, 2)
        want = tpoly.powers_mul_array_plain(a, k)
    got = np.fromfile(sim / "out.bin", np.uint32).reshape(n, 8)
    assert np.array_equal(got, _u32(want))


def _fr_mont(vals):
    """Fr values -> (len, 17) Montgomery limbs."""
    return torch.from_numpy(np.stack([FR_SPEC.to_mont(v) for v in vals]))


def _fr_rand(rng, n):
    """n Fr values: 0, 1 and N - 1 first, then random ones."""
    return ([0, 1, FR_SPEC.N - 1] + [int.from_bytes(rng.bytes(32), "little") % FR_SPEC.N for _ in range(n)])[:n]


def _glue_case(name, rng):
    """(op, a, b, dim) of the glue's shapes, strides and domain edges."""
    N, L = FR_SPEC.N, FR_SPEC.L
    if name == "mul_bcast":  # x[:, None, :] against (1, K, L) constants, one block
        return "mul", _fr_mont(_fr_rand(rng, 3))[:, None, :], _fr_mont(_fr_rand(rng, 5))[None], None
    if name == "mul_bcast_blocks":  # three leading dims that do not coalesce; ragged, several blocks
        a = _fr_mont(_fr_rand(rng, 45)).reshape(5, 1, 9, L)
        return "mul", a, _fr_mont(_fr_rand(rng, 7)[::-1]).reshape(1, 7, 1, L), None
    if name == "to_mont_edges":  # values up to 2^256 - 1 times R^2, and lazy limbs at 2^16 + 2^8 times < N
        canon = [0, 1, N - 1, (1 << 256) - 1, (1 << 256) - 2] + [int.from_bytes(rng.bytes(32), "little")
                                                                for _ in range(4)]
        a = torch.from_numpy(np.stack([limb.int_to_limbs(v, L) for v in canon]))
        lazy = torch.full((4, L), (1 << 16) + (1 << 8), dtype=torch.int64)
        lazy[:, L - 1] = 0
        lazy[1, :8] = 0xFFFF
        a = torch.cat([a, lazy])
        b = torch.cat([torch.from_numpy(FR_SPEC.r2_limbs)[None].expand(len(canon), L), _fr_mont(_fr_rand(rng, 4))])
        return "mul", a, b, None
    if name == "add_vec":  # (B, L) against (L,), N - 1 + N - 1 among them
        return "add", _fr_mont(_fr_rand(rng, 40)), _fr_mont([N - 1])[0], None
    pooled = _fr_mont(_fr_rand(rng, 6 * 7)[::-1]).reshape(6, 7, L)
    if name == "sub_slices":  # pooled[:, a:b, :] against x[:, None, :]
        return "sub", pooled[:, 2:5, :], _fr_mont(_fr_rand(rng, 6))[:, None, :], None
    if name == "sub_rows":  # vals[:, s] against a (B, L) row
        return "sub", pooled[:, 3], _fr_mont(_fr_rand(rng, 6)), None
    if name == "neg":  # sub(0, a)
        return "sub", torch.zeros(L, dtype=torch.int64), _fr_mont(_fr_rand(rng, 33)), None
    if name == "sum_slice":  # basis_van[:, 1 : 1 + bf, :] over dim -2
        return "sum_lazy", _fr_mont(_fr_rand(rng, 5 * 9)).reshape(5, 9, L)[:, 1:7, :], None, -2
    if name == "sum_max":  # the plain version's bound: 2^15 - 1 copies of N - 1
        return "sum_lazy", _fr_mont([N - 1])[None].expand(2, (1 << 15) - 1, L), None, 1
    if name == "dot":  # instance_eval: (B, K, L) . (B, K, L), one operand strided
        b = _fr_mont(_fr_rand(rng, 4 * 6 * 2)[::-1]).reshape(4, 6, 2, L)[:, :, 1, :]
        return "dot_lazy", _fr_mont(_fr_rand(rng, 4 * 6)).reshape(4, 6, L), b, -2
    if name == "limb_strided":  # an element's limbs 12 words apart: copied
        a = _fr_mont(_fr_rand(rng, 12)).T.contiguous().T.reshape(3, 4, L)
        return "mul", a, _fr_mont(_fr_rand(rng, 4)), None
    # five leading dims that do not coalesce: both operands copied
    b = _fr_mont(_fr_rand(rng, 2 * 3 * 2 * 5)).reshape(2, 3, 1, 2, 5, L).permute(4, 1, 2, 0, 3, 5)
    return "mul", b, _fr_mont(_fr_rand(rng, 1)), None


GLUE_PLAIN = {"mul": limb.mont_mul, "add": limb.add, "sub": limb.sub}


@pytest.mark.parametrize("name,copies", [
    ("mul_bcast", 0), ("mul_bcast_blocks", 0), ("to_mont_edges", 0), ("add_vec", 0), ("sub_slices", 0),
    ("sub_rows", 0), ("neg", 0), ("sum_slice", 0), ("sum_max", 0), ("dot", 0), ("limb_strided", 1), ("five_dims", 2),
])
def test_fr_glue_kernels_on_cpu_threads(sim, name, copies):
    """csrc/fr_glue.cu's entry point on the geometry its wrapper gives
    (cuda_fr.layout: the broadcast operands' strides, the dims coalesced,
    the copies counted) limb for limb against ops/limb.py's plain versions,
    with no word written past the output's rows: broadcast and strided
    operands at ragged counts in one and several blocks; 0, 1 and N - 1;
    to_mont of values up to 2^256 - 1, products of lazy limbs at 2^16 +
    2^8; a sum of 2^15 - 1 copies of N - 1."""
    rng = np.random.default_rng(sum(map(ord, name)))
    op, a, b, dim = _glue_case(name, rng)
    b = a if b is None else b
    before = cuda_fr.layout_copies
    a2, b2, shape, geom = cuda_fr.layout(a, b, dim)
    assert cuda_fr.layout_copies - before == copies
    files = []
    for t, f in ((a2, "a.bin"), (b2, "b.bin")):
        flat = t.as_strided((t.untyped_storage().nbytes() // 8,), (1,), 0).contiguous()
        flat.numpy().tofile(sim / f)
        files += [flat.numel(), t.storage_offset()]
    np.array(geom, np.int64).tofile(sim / "geom.bin")
    _run(sim, "g", cuda_fr.OPS.index(op), *files)
    got = np.fromfile(sim / "out.bin", np.int64).reshape(shape)
    if op in GLUE_PLAIN:
        want = GLUE_PLAIN[op](FR_SPEC, a, b)
    elif op == "sum_lazy":
        want = limb.sum_lazy(FR_SPEC, a, dim)
    else:
        want = limb.dot_lazy(FR_SPEC, a, b, dim)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("rows", [3, 2])
def test_pairing_kernel_on_cpu_threads(sim, rows):
    """csrc/pairing.cu's kernel (its tables, slot layout and operand path;
    the carry chain of a combination's reduction in plain C) on seven rows
    of e(el, [s]G2) e(er, G2): true where er = -[s] el, the identity on
    either side and on both, ragged against the rows per block. A two-point
    row runs the stages of pairing_program's critical path."""
    s, g = 0xC0FFEE, rc.G1_GEN
    sides = [(None, None), (rc.g1_mul(g, 5), rc.g1_neg(rc.g1_mul(g, 5 * s))), (rc.g1_mul(g, 7), rc.g1_mul(g, 11)),
             (None, rc.g1_mul(g, 3)), (rc.g1_mul(g, 9), None), (rc.g1_mul(g, 13), rc.g1_neg(rc.g1_mul(g, 13 * s))),
             (rc.g1_mul(g, 2), rc.g1_mul(g, 2 * s))]
    want = [1, 1, 0, 0, 0, 1, 0]
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, s)), tp.prepare_g2(rc.G2_GEN))
    for j, f in enumerate(("el.bin", "er.bin")):
        np.stack([tc.host_point_to_mont(row[j]) for row in sides]).astype(np.int64).tofile(sim / f)
    tab, scratch, tab_words = pairing_program.kernel_tables()
    tab.tofile(sim / "tab.bin")
    pp.lines.astype(np.int32).tofile(sim / "lines.bin")
    np.array([w for v in pairing_program.const_ints() for w in _build.words(v, 12)], np.uint32).tofile(sim / "consts.bin")
    _run(sim, "q", len(sides), rows, pairing_program.row_slots(scratch), tab_words, pp.lines.size)
    assert np.fromfile(sim / "out.bin", np.int32).tolist() == want
    stages = np.fromfile(sim / "ph.bin", np.int64).reshape(-1, 10)[:, 9]
    lanes = _build.launch_constant("pairing.cu", "PAIR_LANES")
    assert stages[1] == stages[5] == stages[6] == pairing_program.program_stats()["row"][lanes]["stages"]
    assert stages[0] == 0 and 0 < stages[3] < stages[1] and 0 < stages[4] < stages[1]
