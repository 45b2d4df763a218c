// Tensor-core probe kernels: replace the three pallas_calls of
// tools/mxu_probe.py (:46 the single int8 product, :101 the int8 chain,
// :122 the bf16 chain).
//
// What they compute: mat (96, 48) int8 times vec (48, B) int8, the shape of
// a Montgomery reduction by a constant modulus in 8-bit sublimbs (a 2 L8 x
// L8 Toeplitz matrix of a 24-limb field times a batch of B columns):
//   ph2_mma_int8_dot   out (96, B) int32 = mat . vec, exact int32 sums;
//   ph2_mma_int8_chain out (48, B) int32 after `steps` dependent steps
//                      acc <- ((mat . acc) & 0x7F)[:48] as int8, acc0 = vec;
//   ph2_mma_bf16_chain the same chain with bf16 operands and f32 sums, cast
//                      to int32 and masked at each step.
// Every value is an integer in [0, 127], so a 48-term sum is below 2^20:
// exact in int32 and in f32 (24 significant bits); bf16 holds every integer
// up to 256. The two chains compute the same integer function.
//
// Bound: the single product moves 96*48 + 48 B + 4*96 B bytes and needs
// 2*96*48*B operations, far below the tensor cores' rate (1,979 int8 TOPS,
// 989 bf16 TFLOP/s dense on an H100 SXM), so it is bound by bytes. A chain
// is 200 products of which each needs the one before it; a step's output is
// only rows 0-47, so the function needs 2*48*48*B operations per step,
// although each step computes all 96 rows as the Pallas kernel does. Its
// time is 200 step latencies (product, store to shared memory, barrier,
// mask), far above any throughput bound. That step latency is what the
// probe reports.
//
// Design: the instruction is the kernel's own choice, nvcuda::wmma
// m16n16k16 (mma.sync underneath): signed char -> int for the int8 kernels,
// __nv_bfloat16 -> float for the bf16 chain. One block per tile of NT = 64
// columns, four warps, one 16-column strip per warp; mat and the tile's
// accumulator sit in shared memory as contiguous 16x16 tiles (so every
// fragment pointer is 256-bit aligned as wmma requires); the ragged last
// tile is zero-padded in shared memory and not stored. A chain loops its
// steps inside the block. Each step computes all 96 rows, stores the
// fragments to shared memory, synchronises, then masks and narrows rows
// 0-47 back into the accumulator.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

constexpr int M = 96, K = 48, T = 16, MT = M / T, KT = K / T;  // 6 x 3 tiles of mat
constexpr int NT = 64, WARPS = NT / T;                          // columns and warps per block

template <class E> struct Sum;
template <> struct Sum<signed char> { using type = int; };
template <> struct Sum<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ void to_e(signed char& e, int v) { e = (signed char)v; }
__device__ __forceinline__ void to_e(__nv_bfloat16& e, int v) { e = __int2bfloat16_rn(v); }
__device__ __forceinline__ int to_int(int v) { return v; }
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int to_int(signed char v) { return v; }
__device__ __forceinline__ int to_int(__nv_bfloat16 v) { return __float2int_rz(__bfloat162float(v)); }

// offset of element (k, n) of the accumulator: col-major 16x16 tiles, tile
// (k / 16, n / 16) at ((n / 16) * KT + k / 16) * 256
__device__ __forceinline__ int b_at(int k, int n) {
  return ((n / T) * KT + k / T) * T * T + (n % T) * T + (k % T);
}

template <class E, bool CHAIN>
__global__ void __launch_bounds__(WARPS * 32)
mma_probe_kernel(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps) {
  using S = typename Sum<E>::type;
  __shared__ __align__(128) E sA[M * K];   // row-major 16x16 tiles, tile (mi, ki) at (mi * KT + ki) * 256
  __shared__ __align__(128) E sB[K * NT];  // the column tile's accumulator, b_at layout
  __shared__ __align__(128) S sC[M * NT];  // one step's product, row-major, leading dimension NT
  const int n0 = blockIdx.x * NT, tid = threadIdx.x, warp = tid / 32;
  for (int i = tid; i < M * K; i += blockDim.x) {
    const int r = i / K, c = i % K;
    to_e(sA[((r / T) * KT + c / T) * T * T + (r % T) * T + c % T], mat[i]);
  }
  for (int i = tid; i < K * NT; i += blockDim.x) {
    const int k = i / NT, n = i % NT;
    to_e(sB[b_at(k, n)], n0 + n < B ? vec[(size_t)k * B + n0 + n] : 0);
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, T, T, T, E, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, T, T, T, E, wmma::col_major> fb[KT];
  wmma::fragment<wmma::accumulator, T, T, T, S> fc;
  const int n_steps = CHAIN ? steps : 1;
  for (int s = 0; s < n_steps; s++) {
#pragma unroll
    for (int ki = 0; ki < KT; ki++) wmma::load_matrix_sync(fb[ki], sB + (warp * KT + ki) * T * T, T);
#pragma unroll
    for (int mi = 0; mi < MT; mi++) {
      wmma::fill_fragment(fc, (S)0);
#pragma unroll
      for (int ki = 0; ki < KT; ki++) {
        wmma::load_matrix_sync(fa, sA + (mi * KT + ki) * T * T, T);
        wmma::mma_sync(fc, fa, fb[ki], fc);
      }
      wmma::store_matrix_sync(sC + mi * T * NT + warp * T, fc, NT, wmma::mem_row_major);
    }
    __syncthreads();
    if (CHAIN) {
      for (int i = tid; i < K * NT; i += blockDim.x) {
        const int k = i / NT, n = i % NT;
        to_e(sB[b_at(k, n)], to_int(sC[k * NT + n]) & 0x7F);
      }
      __syncthreads();
    }
  }

  if (CHAIN) {
    for (int i = tid; i < K * NT; i += blockDim.x) {
      const int k = i / NT, n = i % NT;
      if (n0 + n < B) out[(size_t)k * B + n0 + n] = to_int(sB[b_at(k, n)]);
    }
  } else {
    for (int i = tid; i < M * NT; i += blockDim.x) {
      const int r = i / NT, n = i % NT;
      if (n0 + n < B) out[(size_t)r * B + n0 + n] = to_int(sC[i]);
    }
  }
}

template <class E, bool CHAIN>
static int launch(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps, void* stream) {
  if (B > 0)
    mma_probe_kernel<E, CHAIN><<<(B + NT - 1) / NT, WARPS * 32, 0, (cudaStream_t)stream>>>(mat, vec, out, B, steps);
  return (int)cudaGetLastError();
}

extern "C" int ph2_mma_int8_dot(const int8_t* mat, const int8_t* vec, int32_t* out, int B, void* stream) {
  return launch<signed char, false>(mat, vec, out, B, 1, stream);
}

extern "C" int ph2_mma_int8_chain(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps,
                                  void* stream) {
  return launch<signed char, true>(mat, vec, out, B, steps, stream);
}

extern "C" int ph2_mma_bf16_chain(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps,
                                  void* stream) {
  return launch<__nv_bfloat16, true>(mat, vec, out, B, steps, stream);
}
