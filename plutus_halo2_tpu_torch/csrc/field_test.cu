// Elementwise Montgomery-product test kernel for the device field library:
// the counterpart of the test-only pallas_call in
// tests/test_pallas_core.py:123 (test_pallas_call_interpret_mul, :139).
//
// What it computes: a * b / R for every element pair of two (n, L) slabs of
// the port's Montgomery limbs, through load_port / f_mul / store_port, so a
// field-library bug shows up here before it hides inside a larger kernel.
//
// Bound: integer multiply throughput, 4 CIOS products per element (two
// input conversions, the product, one output conversion): Fp 4 * 288 =
// 1,152 and Fr 4 * 128 = 512 32x32 word multiplies.
//
// Design: one thread per element.
#include "lanes.cuh"

template <class F>
__global__ void mont_mul_kernel(const int64_t* a, const int64_t* b, int64_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::NW], y[F::NW];
  load_port<F>(x, a + (size_t)i * F::L16);
  load_port<F>(y, b + (size_t)i * F::L16);
  f_mul<F>(x, x, y);
  store_port<F>(out + (size_t)i * F::L16, x);
}

template <class F>
static int launch_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  if (n > 0) mont_mul_kernel<F><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int ph2_mont_mul_fp(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  return launch_mont_mul<FpT>(a, b, out, n, stream);
}

extern "C" int ph2_mont_mul_fr(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  return launch_mont_mul<FrT>(a, b, out, n, stream);
}

// ---- latency probe of the Fp primitives -------------------------------------
// Each thread runs `steps` dependent steps of one primitive on its own
// values (x: 36 words per thread, canonical kernel-domain a, b, c); lane 0
// of each warp records the clock64() cycles of the loop. Variants: 0 f_mul,
// 1 f_mul2 (two independent products), 2 fp_mul_cc, 3 two fp_mul_cc,
// 4 f_add, 5 fp_add_cc, 6 f_sub, 7 fp_sub_cc.
template <int V>
__global__ void fp_step_probe(const uint32_t* x, uint32_t* out, long long* cycles, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[12], b[12], c[12];
#pragma unroll
  for (int k = 0; k < 12; k++) {
    a[k] = x[(size_t)i * 36 + k];
    b[k] = x[(size_t)i * 36 + 12 + k];
    c[k] = x[(size_t)i * 36 + 24 + k];
  }
  const long long t0 = clock64();
#pragma unroll 1
  for (int s = 0; s < steps; s++) {
    if (V == 0) f_mul<FpT>(a, a, b);
    if (V == 1) f_mul2<FpT>(a, a, b, c, c, b);
    if (V == 2) fp_mul_cc(a, a, b);
    if (V == 3) {
      fp_mul_cc(a, a, b);
      fp_mul_cc(c, c, b);
    }
    if (V == 4) f_add<FpT>(a, a, b);
    if (V == 5) fp_add_cc(a, a, b);
    if (V == 6) f_sub<FpT>(a, a, b);
    if (V == 7) fp_sub_cc(a, a, b);
  }
  const long long t1 = clock64();
#pragma unroll
  for (int k = 0; k < 12; k++) {
    out[(size_t)i * 24 + k] = a[k];
    out[(size_t)i * 24 + 12 + k] = c[k];
  }
  if (threadIdx.x % 32 == 0) cycles[i / 32] = t1 - t0;
}

// blocks x (32 warps) threads; x holds 36 words a thread, out 24, cycles one a warp
extern "C" int ph2_fp_step_probe(const uint32_t* x, uint32_t* out, long long* cycles, int blocks, int warps,
                                 int steps, int variant, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g(blocks), t(32 * warps);
  switch (variant) {
    case 0: fp_step_probe<0><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 1: fp_step_probe<1><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 2: fp_step_probe<2><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 3: fp_step_probe<3><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 4: fp_step_probe<4><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 5: fp_step_probe<5><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 6: fp_step_probe<6><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    case 7: fp_step_probe<7><<<g, t, 0, s>>>(x, out, cycles, steps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- latency probe of the lane-split product --------------------------------
// Each element runs `steps` dependent products acc = acc b on its own values
// (x: 2 NW words an element, canonical kernel-domain acc and b), on one
// thread (T = 1, f_mul) or on a group of T lanes (lanes_gather, then
// f_mul_lanes: a squaring step of pow.cu); out: NW words an element; lane 0
// of each warp records the clock64() cycles of the loop.
template <class F, int T>
__global__ void lanes_step_probe(const uint32_t* x, uint32_t* out, long long* cycles, int steps) {
  constexpr int NW = F::NW;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) / T;
  const uint32_t* src = x + (size_t)e * 2 * NW;
  long long t0, t1;
  if constexpr (T == 1) {
    uint32_t a[NW], b[NW];
#pragma unroll
    for (int k = 0; k < NW; k++) {
      a[k] = src[k];
      b[k] = src[NW + k];
    }
    t0 = clock64();
#pragma unroll 1
    for (int s = 0; s < steps; s++) f_mul<F>(a, a, b);
    t1 = clock64();
#pragma unroll
    for (int k = 0; k < NW; k++) out[(size_t)e * NW + k] = a[k];
  } else {
    constexpr int S = NW / T;
    const Lanes<F, T> g(threadIdx.x % T);
    uint32_t acc[S], b[S], full[NW];
#pragma unroll
    for (int k = 0; k < S; k++) {
      acc[k] = src[g.l * S + k];
      b[k] = src[NW + g.l * S + k];
    }
    t0 = clock64();
#pragma unroll 1
    for (int s = 0; s < steps; s++) {
      lanes_gather<F, T>(full, acc, g);
      f_mul_lanes<F, T>(acc, full, b, g);
    }
    t1 = clock64();
#pragma unroll
    for (int k = 0; k < S; k++) out[(size_t)e * NW + g.l * S + k] = acc[k];
  }
  if (threadIdx.x % 32 == 0) cycles[(blockIdx.x * blockDim.x + threadIdx.x) / 32] = t1 - t0;
}

template <class F, int T>
static void launch_lanes_probe(const uint32_t* x, uint32_t* out, long long* cycles, int blocks, int warps,
                               int steps, cudaStream_t s) {
  lanes_step_probe<F, T><<<blocks, 32 * warps, 0, s>>>(x, out, cycles, steps);
}

// blocks x (32 warps) threads; field 0 Fp, 1 Fr; lanes 1 (f_mul), 2, 4 or
// 8 (Fr only) a product; x holds 2 NW words an element (32 warps / lanes
// elements a block), out NW, cycles one a warp
extern "C" int ph2_lanes_step_probe(const uint32_t* x, uint32_t* out, long long* cycles, int blocks, int warps,
                                    int steps, int field, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int key = 10 * field + lanes;
  switch (key) {
    case 1: launch_lanes_probe<FpT, 1>(x, out, cycles, blocks, warps, steps, s); break;
    case 2: launch_lanes_probe<FpT, 2>(x, out, cycles, blocks, warps, steps, s); break;
    case 4: launch_lanes_probe<FpT, 4>(x, out, cycles, blocks, warps, steps, s); break;
    case 11: launch_lanes_probe<FrT, 1>(x, out, cycles, blocks, warps, steps, s); break;
    case 12: launch_lanes_probe<FrT, 2>(x, out, cycles, blocks, warps, steps, s); break;
    case 14: launch_lanes_probe<FrT, 4>(x, out, cycles, blocks, warps, steps, s); break;
    case 18: launch_lanes_probe<FrT, 8>(x, out, cycles, blocks, warps, steps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
