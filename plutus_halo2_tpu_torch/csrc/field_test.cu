// Elementwise Montgomery-product test kernel for the device field library:
// the counterpart of the test-only pallas_call in
// tests/test_pallas_core.py:123 (test_pallas_call_interpret_mul, :139).
//
// What it computes: a * b / R for every element pair of two (n, L) slabs of
// the port's Montgomery limbs (R = R16 = 2^(16 L)), through the library's
// f_mul, so a field-library bug shows up here before it hides inside a
// larger kernel.
//
// Bound: its bytes. An element reads two rows and writes one, 3 x 8 L
// bytes (Fp 600, Fr 408), at 3.35 TB/s; the one Montgomery product the
// function needs (Fp 300, Fr 136 word products) takes less at the card's
// integer rate.
//
// Design. The port's two boundary conversions fold into one constant: with
// x = a R16 and y = b R16 packed from the limbs (R32 = 2^(32 NW), the
// kernels' R), f_mul(x, y) = a b R16^2 / R32, and f_mul by F::to_k =
// R32^2 / R16 mod N gives a b R16, the port's product. It is fully reduced,
// so its limbs are the plain version's: two CIOS products an element where
// load_port, f_mul and store_port take four. A block's rows are contiguous
// in the slabs, so the block moves them through shared memory with 16-byte
// accesses, neighbouring threads on neighbouring addresses (read from
// global memory a row a thread, neighbours sit 8 L bytes apart and no
// access coalesces); each thread then reads
// its own row there (a row's 64-bit words fall on distinct banks across a
// half-warp: a stride of 50 or 34 words) and writes its product back over
// it. MONT_MUL_THREADS rows a block, two slabs of shared memory a block.
#include "lanes.cuh"

constexpr int MONT_MUL_MAX_THREADS = 512;
// threads (rows) a block: the fastest of 32 to 512 on an H100 at 2^16 pairs
constexpr int MONT_MUL_THREADS = 128;

// int64 words a block's slab of `threads` rows of L words holds: the rows
// and a head word, rounded up to 16 bytes
__host__ __device__ constexpr int slab_words(int threads, int L) { return (threads * L + 2) & ~1; }

// whether p lies 8 bytes past a 16-byte boundary: then word j of p sits in
// word j + 1 of a slab, so that p's 16-byte aligned words land on the
// slab's 16-byte aligned words
__device__ __forceinline__ int head_of(const int64_t* p) { return (int)((reinterpret_cast<uintptr_t>(p) >> 3) & 1); }

// words [0, nw) of src into s[h, h + nw), h = head_of(src): 16-byte loads,
// and the head and tail word alone
__device__ __forceinline__ void stage_in(int64_t* s, const int64_t* src, int nw) {
  const int h = head_of(src), np = (nw - h) >> 1;
  const uint4* g = reinterpret_cast<const uint4*>(src + h);
  uint4* d = reinterpret_cast<uint4*>(s + 2 * h);
#pragma unroll 4
  for (int i = threadIdx.x; i < np; i += blockDim.x) d[i] = g[i];
  if (threadIdx.x == 0 && h) s[1] = src[0];
  if (threadIdx.x == 0 && ((nw - h) & 1)) s[h + nw - 1] = src[nw - 1];
}

// s[h, h + nw) to words [0, nw) of dst, h = head_of(dst): 16-byte stores
__device__ __forceinline__ void stage_out(int64_t* dst, const int64_t* s, int nw) {
  const int h = head_of(dst), np = (nw - h) >> 1;
  const uint4* g = reinterpret_cast<const uint4*>(s + 2 * h);
  uint4* d = reinterpret_cast<uint4*>(dst + h);
#pragma unroll 4
  for (int i = threadIdx.x; i < np; i += blockDim.x) d[i] = g[i];
  if (threadIdx.x == 0 && h) dst[0] = s[1];
  if (threadIdx.x == 0 && ((nw - h) & 1)) dst[nw - 1] = s[h + nw - 1];
}

template <class F>
__global__ void __launch_bounds__(MONT_MUL_MAX_THREADS)
mont_mul_kernel(const int64_t* a, const int64_t* b, int64_t* out, int n) {
  constexpr int L = F::L16, NW = F::NW;
  extern __shared__ __align__(16) uint32_t smem[];
  int64_t* sa = reinterpret_cast<int64_t*>(smem);  // a's rows, then the products'
  int64_t* sb = sa + slab_words(blockDim.x, L);    // b's rows
  const int r = threadIdx.x, r0 = blockIdx.x * blockDim.x, rows = min((int)blockDim.x, n - r0), nw = rows * L;
  const size_t w0 = (size_t)r0 * L;
  stage_in(sa, a + w0, nw);
  stage_in(sb, b + w0, nw);
  __syncthreads();
  uint32_t x[NW], y[NW];
  const int64_t* ra = sa + head_of(a + w0) + r * L;
  const int64_t* rb = sb + head_of(b + w0) + r * L;
#pragma unroll
  for (int i = 0; i < NW; i++) {  // limbs 2 NW .. L - 1 of a canonical value are 0
    x[i] = r < rows ? (uint32_t)ra[2 * i] | (uint32_t)ra[2 * i + 1] << 16 : 0u;
    y[i] = r < rows ? (uint32_t)rb[2 * i] | (uint32_t)rb[2 * i + 1] << 16 : 0u;
  }
  __syncthreads();  // every row read before a product's row, at out's head, overwrites one
  if (r < rows) {
    uint32_t c[NW];
#pragma unroll
    for (int i = 0; i < NW; i++) c[i] = F::to_k(i);
    f_mul<F>(x, x, y);
    f_mul<F>(x, x, c);
    int64_t* ro = sa + head_of(out + w0) + r * L;
#pragma unroll
    for (int i = 0; i < NW; i++) {
      ro[2 * i] = x[i] & 0xffffu;
      ro[2 * i + 1] = x[i] >> 16;
    }
#pragma unroll
    for (int i = 2 * NW; i < L; i++) ro[i] = 0;
  }
  __syncthreads();
  stage_out(out + w0, sa, nw);
}

template <class F>
static int launch_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int smem = 2 * slab_words(MONT_MUL_THREADS, F::L16) * (int)sizeof(int64_t);
  cudaError_t e = cudaFuncSetAttribute(mont_mul_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  mont_mul_kernel<F><<<(n + MONT_MUL_THREADS - 1) / MONT_MUL_THREADS, MONT_MUL_THREADS, smem, (cudaStream_t)stream>>>(
      a, b, out, n);
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
