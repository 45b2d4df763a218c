// Tensor-core probe kernels: replace two of the three pallas_calls of
// tools/mxu_probe.py (:46 the single int8 product, :101 the int8 chain);
// the third (:122, the bf16 chain) is csrc/mma_chain.cu.
//
// What they compute: mat (96, 48) int8 times vec (48, B) int8, the shape of
// a Montgomery reduction by a constant modulus in 8-bit sublimbs (a 2 L8 x
// L8 Toeplitz matrix of a 24-limb field times a batch of B columns):
//   ph2_mma_int8_dot   out (96, B) int32 = mat . vec, exact int32 sums;
//   ph2_mma_int8_chain out (48, B) int32 after `steps` dependent steps
//                      acc <- ((mat . acc) & 0x7F)[:48] as int8, acc0 = vec.
// Every value is an integer in [0, 127], so a 48-term sum is below 2^20:
// exact in int32.
//
// Bound: the single product moves 96*48 + 48 B + 4*96 B bytes and needs
// 2*96*48*B operations, far below the tensor cores' rate (1,979 int8 TOPS
// dense on an H100 SXM), so it is bound by bytes. A chain is 200 products
// of which each needs the one before it; a step's output is only rows 0-47,
// so the function needs 2*48*48*B operations per step, although each step
// computes all 96 rows as the Pallas kernel does. Its time is 200 step
// latencies (product, store to shared memory, barrier, mask), far above any
// throughput bound. That step latency is what the probe reports.
//
// Design of the single product (int8_dot_kernel): one warp per block and 16
// columns per warp, so B = 1024 spreads over 64 blocks; mma.sync
// m16n8k16 s8.s8.s32 with its fragments loaded straight from global memory
// (a row of mat gives a 4-byte A register; B registers pack 4 k-consecutive
// bytes of a column) and the accumulator fragments stored straight to out,
// with no staging in shared memory. wgmma, whose tiles are 64 rows with B
// from shared memory, does not fit a 96 x 48 product at this size and was
// not used.
//
// Design of the int8 chain: the instruction is the kernel's own choice,
// nvcuda::wmma m16n16k16 (mma.sync underneath), signed char -> int. One
// block per tile of NT = 64 columns, four warps, one 16-column strip per
// warp; mat and the tile's accumulator sit in shared memory as contiguous
// 16x16 tiles (so every fragment pointer is 256-bit aligned as wmma
// requires); the ragged last tile is zero-padded in shared memory and not
// stored. The chain loops its steps inside the block. Each step computes
// all 96 rows, stores the fragments to shared memory, synchronises, then
// masks and narrows rows 0-47 back into the accumulator.
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

constexpr int M = 96, K = 48, T = 16, MT = M / T, KT = K / T;  // 6 x 3 tiles of mat
constexpr int NT = 64, WARPS = NT / T;                          // columns and warps per block

// offset of element (k, n) of the accumulator: col-major 16x16 tiles, tile
// (k / 16, n / 16) at ((n / 16) * KT + k / 16) * 256
__device__ __forceinline__ int b_at(int k, int n) {
  return ((n / T) * KT + k / T) * T * T + (n % T) * T + (k % T);
}

// out (96, B) = mat (96, 48) . vec (48, B): 6 row tiles x 3 k-steps of
// m16n8k16 per 8-column tile, two column tiles per warp
__global__ void __launch_bounds__(32) int8_dot_kernel(const int8_t* mat, const int8_t* vec, int32_t* out, int B) {
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * 16;
  uint32_t b[2][KT];
#pragma unroll
  for (int nt = 0; nt < 2; nt++) {
    const int n = n0 + nt * 8 + g;
#pragma unroll
    for (int ks = 0; ks < KT; ks++) {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const uint32_t v = n < B ? (uint8_t)vec[(size_t)(ks * T + q * 4 + i) * B + n] : 0u;
        w |= v << (8 * i);
      }
      b[nt][ks] = w;
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; mt++) {
    int c[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KT; ks++) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(mat + (mt * T + g) * K + ks * T + q * 4);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(mat + (mt * T + g + 8) * K + ks * T + q * 4);
#pragma unroll
      for (int nt = 0; nt < 2; nt++)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
            : "+r"(c[nt][0]), "+r"(c[nt][1]), "+r"(c[nt][2]), "+r"(c[nt][3])
            : "r"(a0), "r"(a1), "r"(b[nt][ks]));
    }
#pragma unroll
    for (int nt = 0; nt < 2; nt++) {
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const int row = mt * T + g + (i >> 1) * 8, n = n0 + nt * 8 + q * 2 + (i & 1);
        if (n < B) out[(size_t)row * B + n] = c[nt][i];
      }
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
mma_probe_kernel(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps) {
  __shared__ __align__(128) signed char sA[M * K];   // row-major 16x16 tiles, tile (mi, ki) at (mi * KT + ki) * 256
  __shared__ __align__(128) signed char sB[K * NT];  // the column tile's accumulator, b_at layout
  __shared__ __align__(128) int sC[M * NT];          // one step's product, row-major, leading dimension NT
  // (the accumulator's rows 0-47 are the next step's input)
  const int n0 = blockIdx.x * NT, tid = threadIdx.x, warp = tid / 32;
  for (int i = tid; i < M * K; i += blockDim.x) {
    const int r = i / K, c = i % K;
    sA[((r / T) * KT + c / T) * T * T + (r % T) * T + c % T] = mat[i];
  }
  for (int i = tid; i < K * NT; i += blockDim.x) {
    const int k = i / NT, n = i % NT;
    sB[b_at(k, n)] = n0 + n < B ? vec[(size_t)k * B + n0 + n] : 0;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, T, T, T, signed char, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, T, T, T, signed char, wmma::col_major> fb[KT];
  wmma::fragment<wmma::accumulator, T, T, T, int> fc;
  for (int s = 0; s < steps; s++) {
#pragma unroll
    for (int ki = 0; ki < KT; ki++) wmma::load_matrix_sync(fb[ki], sB + (warp * KT + ki) * T * T, T);
#pragma unroll
    for (int mi = 0; mi < MT; mi++) {
      wmma::fill_fragment(fc, 0);
#pragma unroll
      for (int ki = 0; ki < KT; ki++) {
        wmma::load_matrix_sync(fa, sA + (mi * KT + ki) * T * T, T);
        wmma::mma_sync(fc, fa, fb[ki], fc);
      }
      wmma::store_matrix_sync(sC + mi * T * NT + warp * T, fc, NT, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < K * NT; i += blockDim.x) {
      const int k = i / NT, n = i % NT;
      sB[b_at(k, n)] = (signed char)(sC[k * NT + n] & 0x7F);
    }
    __syncthreads();
  }
  for (int i = tid; i < K * NT; i += blockDim.x) {
    const int k = i / NT, n = i % NT;
    if (n0 + n < B) out[(size_t)k * B + n0 + n] = sB[b_at(k, n)];
  }
}

extern "C" int ph2_mma_int8_dot(const int8_t* mat, const int8_t* vec, int32_t* out, int B, void* stream) {
  if (B > 0) int8_dot_kernel<<<(B + 15) / 16, 32, 0, (cudaStream_t)stream>>>(mat, vec, out, B);
  return (int)cudaGetLastError();
}

extern "C" int ph2_mma_int8_chain(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps,
                                  void* stream) {
  if (B > 0)
    mma_probe_kernel<<<(B + NT - 1) / NT, WARPS * 32, 0, (cudaStream_t)stream>>>(mat, vec, out, B, steps);
  return (int)cudaGetLastError();
}
