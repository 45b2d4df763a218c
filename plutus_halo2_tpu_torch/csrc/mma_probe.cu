// The tensor-core probe's single product: replaces tools/mxu_probe.py:46
// (the first of its three pallas_calls; the two chains, :101 and :122, are
// csrc/mma_chain.cu).
//
// What it computes: mat (96, 48) int8 times vec (48, B) int8, the shape of
// a Montgomery reduction by a constant modulus in 8-bit sublimbs (a 2 L8 x
// L8 Toeplitz matrix of a 24-limb field times a batch of B columns):
//   ph2_mma_int8_dot   out (96, B) int32 = mat . vec, exact int32 sums.
//
// Bound: it moves 96*48 + 48 B + 4*96 B bytes and needs 2*96*48*B
// operations, far below the tensor cores' rate (1,979 int8 TOPS dense on
// an H100 SXM), so it is bound by bytes.
//
// Design (int8_dot_kernel): one warp per block and 16 columns per warp, so
// B = 1024 spreads over 64 blocks; mma.sync m16n8k16 s8.s8.s32 with its
// fragments loaded straight from global memory (a row of mat gives a 4-byte
// A register; B registers pack 4 k-consecutive bytes of a column) and the
// accumulator fragments stored straight to out, with no staging in shared
// memory. wgmma, whose tiles are 64 rows with B from shared memory, does
// not fit a 96 x 48 product at this size and was not used.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int M = 96, K = 48, T = 16, MT = M / T, KT = K / T;  // 6 x 3 tiles of mat

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

extern "C" int ph2_mma_int8_dot(const int8_t* mat, const int8_t* vec, int32_t* out, int B, void* stream) {
  if (B > 0) int8_dot_kernel<<<(B + 15) / 16, 32, 0, (cudaStream_t)stream>>>(mat, vec, out, B);
  return (int)cudaGetLastError();
}
