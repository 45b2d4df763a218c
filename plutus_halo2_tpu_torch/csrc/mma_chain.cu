// The tensor-core chains: replace tools/mxu_probe.py:122 (the bf16 chain's
// pallas_call) and :101 (the int8 chain's).
//
// What they compute: mat (96, 48) int8, vec (48, B) int8; `steps` dependent
// steps acc <- ((mat . acc) & 0x7F)[:48], acc0 = vec; out (48, B) int32 =
// acc. The bf16 chain multiplies bf16 operands with f32 sums, the int8
// chain s8 operands with s32 sums. Every value is an integer of at most 8
// bits, so a 48-term sum is below 2^20: exact in f32 and in s32, and bf16
// holds every integer up to 256. The two chains compute one function, bit
// for bit.
//
// Bound: 2 * 48 * 48 * B operations a step at the tensor cores' bf16 or
// int8 rate, far below what a chain of `steps` dependent products can
// approach; the time is `steps` step latencies.
//
// Design: the product transposed, acc^T (B x 48) . mat[:48]^T (48 x 48),
// on mma.sync. A warp owns 16 batch columns, the A operand's rows;
// mat[:48]^T, the B operand, is converted once and stays in registers for
// the whole chain. Only rows 0-47 of the product are computed: they are the
// function's whole output. Each step's accumulators become the next step's
// A fragment in the same lane, so the mask runs in registers and the step
// loop has no shared memory, barrier or shuffle. A ragged last warp
// computes on zero columns and stores nothing.
//
// bf16 (m16n8k16 bf16 -> f32): a step is 18 mma, 6 independent n-tiles of
// 3 dependent k-slices; B is 3 k-slices x 6 n8-tiles x 2 registers. By the
// PTX ISA's m16n8k16 fragment layouts (g = lane / 4, q = lane % 4) an
// accumulator holds (g, 2q..2q+1) and (g+8, 2q..2q+1) of its n8-tile, and an
// A fragment (g, 2q..), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..) of its
// k-slice: the accumulators of n-tiles 2t and 2t+1 sit exactly where the
// next step's A fragment of k-slice t needs them (the sum's low 7 bits, back
// to a float, two bf16 to a register).
//
// int8 (mma.sync s8 -> s32): the s8 fragments pack 4 k-consecutive bytes a
// register, the lowest k in the low byte. By the PTX ISA's layouts
// (m16n8k32 .s8: A a0 (g, 4q..4q+3), a1 (g+8, 4q..), a2 (g, 16+4q..), a3
// (g+8, 16+4q..); B b0 (4q..4q+3, g), b1 (16+4q.., g); m16n8k16 .s8: a0,
// a1 and b0 alone, k 0-15; C/D of both: (g, 2q), (g, 2q+1), (g+8, 2q),
// (g+8, 2q+1) of the n8-tile) a lane's accumulators of n-tiles 2t and 2t+1
// hold, in rows g and g+8, the columns 16t+2q, 16t+2q+1, 16t+8+2q,
// 16t+9+2q: four a row, where the A fragment of k-slice t needs four a row
// at the positions 16t+4q .. 16t+4q+3. So
//   rho(16t + 8h + 2q + e) = 16t + 4q + 2h + e   (t < 3; h, e in {0, 1})
// maps every accumulator column to an A position held by the same lane,
// and the chain runs in permuted coordinates: the state s[p] =
// acc[rho^-1(p)], B[p][c] = mat[c][rho^-1(p)], so
//   D[n][c] = sum_p s[p][n] B[p][c] = sum_k acc[k][n] mat[c][k],
// column c of the product is row c of mat . acc, and its masked byte goes
// to A position rho(c), which makes the new s. The input is loaded and the
// output stored in that order: k = 16t + 2q + {0, 1, 8, 9} for A register
// (t, row half), B register (t, n-tile) alike. A step is 12 mma: per
// n-tile an m16n8k32 over k-slices 0-1 then an m16n8k16 over k-slice 2;
// its mask is 3 byte permutes and an AND a register, 6 registers a lane.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CHAIN_K = 48;     // the accumulator's rows, mat's columns
constexpr int CHAIN_KS = 3;     // k-slices of 16
constexpr int CHAIN_NT = 6;     // n-tiles of 8 (rows 0-47 of the product)
constexpr int CHAIN_MAX_WARPS = 8;
constexpr int CHAIN_WARPS = 1;  // the bf16 chain's warps a block (see int8_chain_kernel)

// d += a . b, one m16n8k16 bf16 product with f32 sums over the warp
#ifdef PH2_CPU_SIM
void mma_bf16_m16n8k16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]);  // the CPU simulation's
#else
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// d += a . b over the warp, s8 operands, s32 sums: m16n8k32 (k-slices 0-1
// of A in a, of B in b) and m16n8k16 (one k-slice)
#ifdef PH2_CPU_SIM
void mma_s8_m16n8k32(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]);  // the CPU simulation's
void mma_s8_m16n8k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b);
#else
__device__ __forceinline__ void mma_s8_m16n8k32(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8_m16n8k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
#endif

// the bf16 halves of a register back to integers
__device__ __forceinline__ int bf16_lo(uint32_t r) { return __float2int_rz(__uint_as_float(r << 16)); }
__device__ __forceinline__ int bf16_hi(uint32_t r) { return __float2int_rz(__uint_as_float(r & 0xffff0000u)); }

// one step's mask of a sum, an exact integer |x| < 2^22, back as a float:
// adding 1.5 * 2^23 puts x + 2^22 in the low mantissa bits, whose low 7
// are x's; 2^23 + v less 2^23 is v. All on the FP32 and integer pipes:
// __float2int_rz and __int2float_rn run on the conversion pipe, 16 lanes a
// clock an SM, and took a step ~440 cycles (PERF.md)
__device__ __forceinline__ float mask7(float x) {
  const uint32_t v = __float_as_uint(x + 12582912.0f) & 0x7Fu;
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// two floats exact in bf16 (low 16 bits zero) as bf16, `lo` in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// two integers of at most 8 significant bits (exact in bf16)
__device__ __forceinline__ uint32_t bf16x2(int lo, int hi) { return bf16x2(__int2float_rn(lo), __int2float_rn(hi)); }

__device__ __forceinline__ int vec_at(const int8_t* vec, int B, int k, int n) {
  return n < B ? (int)vec[(size_t)k * B + n] : 0;
}

__global__ void __launch_bounds__(CHAIN_MAX_WARPS * 32)
bf16_chain_kernel(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int n0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 16, c0 = n0 + g, c1 = n0 + g + 8;
  // B operand: (mat[:48]^T)[k][n] = mat[n][k], n = 8 nt + g, k = 16 ks + 2q (+1, +8, +9)
  uint32_t bm[CHAIN_KS][CHAIN_NT][2];
#pragma unroll
  for (int ks = 0; ks < CHAIN_KS; ks++) {
#pragma unroll
    for (int nt = 0; nt < CHAIN_NT; nt++) {
      const int8_t* r = mat + (nt * 8 + g) * CHAIN_K + ks * 16 + 2 * q;
      bm[ks][nt][0] = bf16x2(r[0], r[1]);
      bm[ks][nt][1] = bf16x2(r[8], r[9]);
    }
  }
  // A operand: acc^T's rows c0 and c1, k-slice t in a[t]
  uint32_t a[CHAIN_KS][4];
#pragma unroll
  for (int t = 0; t < CHAIN_KS; t++) {
    const int k = 16 * t + 2 * q;
    a[t][0] = bf16x2(vec_at(vec, B, k, c0), vec_at(vec, B, k + 1, c0));
    a[t][1] = bf16x2(vec_at(vec, B, k, c1), vec_at(vec, B, k + 1, c1));
    a[t][2] = bf16x2(vec_at(vec, B, k + 8, c0), vec_at(vec, B, k + 9, c0));
    a[t][3] = bf16x2(vec_at(vec, B, k + 8, c1), vec_at(vec, B, k + 9, c1));
  }
  for (int s = 0; s < steps; s++) {
    float d[CHAIN_NT][4];
#pragma unroll
    for (int nt = 0; nt < CHAIN_NT; nt++) {
      d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < CHAIN_KS; ks++) mma_bf16_m16n8k16(d[nt], a[ks], bm[ks][nt]);
    }
#pragma unroll
    for (int t = 0; t < CHAIN_KS; t++) {
      a[t][0] = bf16x2(mask7(d[2 * t][0]), mask7(d[2 * t][1]));
      a[t][1] = bf16x2(mask7(d[2 * t][2]), mask7(d[2 * t][3]));
      a[t][2] = bf16x2(mask7(d[2 * t + 1][0]), mask7(d[2 * t + 1][1]));
      a[t][3] = bf16x2(mask7(d[2 * t + 1][2]), mask7(d[2 * t + 1][3]));
    }
  }
  // out (48, B): acc^T's rows back as columns
#pragma unroll
  for (int t = 0; t < CHAIN_KS; t++) {
    const int k = 16 * t + 2 * q;
    if (c0 < B) {
      out[(size_t)k * B + c0] = bf16_lo(a[t][0]);
      out[(size_t)(k + 1) * B + c0] = bf16_hi(a[t][0]);
      out[(size_t)(k + 8) * B + c0] = bf16_lo(a[t][2]);
      out[(size_t)(k + 9) * B + c0] = bf16_hi(a[t][2]);
    }
    if (c1 < B) {
      out[(size_t)k * B + c1] = bf16_lo(a[t][1]);
      out[(size_t)(k + 1) * B + c1] = bf16_hi(a[t][1]);
      out[(size_t)(k + 8) * B + c1] = bf16_lo(a[t][3]);
      out[(size_t)(k + 9) * B + c1] = bf16_hi(a[t][3]);
    }
  }
}

// CHAIN_WARPS warps a block, 16 batch columns each
extern "C" int ph2_mma_bf16_chain(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps,
                                  void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  const int col_warps = (B + 15) / 16;
  if (B > 0)
    bf16_chain_kernel<<<(col_warps + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32, 0, (cudaStream_t)stream>>>(
        mat, vec, out, B, steps);
  return (int)cudaGetLastError();
}

// four integers' low bytes as the bytes of one register, x0 in the low byte
__device__ __forceinline__ uint32_t s8x4(int x0, int x1, int x2, int x3) {
  return (uint32_t)(x0 & 0xff) | (uint32_t)(x1 & 0xff) << 8 | (uint32_t)(x2 & 0xff) << 16 | (uint32_t)x3 << 24;
}

// one step's mask of four sums: their low 7 bits as the bytes of one
// register, x0 in the low byte (two byte permutes gather the low bytes,
// a third joins them, one AND masks all four)
__device__ __forceinline__ uint32_t mask7x4(int x0, int x1, int x2, int x3) {
  const uint32_t lo = __byte_perm(x0, x1, 0x0040), hi = __byte_perm(x2, x3, 0x0040);
  return __byte_perm(lo, hi, 0x5410) & 0x7F7F7F7Fu;
}

// the k-offsets of a register's four bytes in the permuted order: byte i of
// A register (t, row half) and of B register (t, n-tile) is k = 16t + 2q +
// (i & 1) + 8 (i >> 1)
__device__ __forceinline__ int perm_k(int t, int q, int i) { return 16 * t + 2 * q + (i & 1) + 8 * (i >> 1); }

// one warp a block: a chain step is latency, and a warp alone on an SM
// sub-partition takes it fastest (the bf16 chain's sweep: 1, 2 and 4 warps
// a block alike, 8 slower; PERF.md)
__global__ void __launch_bounds__(32) int8_chain_kernel(const int8_t* mat, const int8_t* vec, int32_t* out, int B,
                                                        int steps) {
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3, c0 = blockIdx.x * 16 + g, c1 = c0 + 8;
  // B operand: B[p][n] = mat[n][rho^-1(p)], n = 8 nt + g
  uint32_t bm[CHAIN_KS][CHAIN_NT];
#pragma unroll
  for (int t = 0; t < CHAIN_KS; t++) {
#pragma unroll
    for (int nt = 0; nt < CHAIN_NT; nt++) {
      const int8_t* r = mat + (nt * 8 + g) * CHAIN_K;
      bm[t][nt] = s8x4(r[perm_k(t, q, 0)], r[perm_k(t, q, 1)], r[perm_k(t, q, 2)], r[perm_k(t, q, 3)]);
    }
  }
  // A operand, the state: k-slice t of acc^T's rows c0 (a[t][0]) and c1
  // (a[t][1]) in the permuted order
  uint32_t a[CHAIN_KS][2];
#pragma unroll
  for (int t = 0; t < CHAIN_KS; t++) {
    a[t][0] = s8x4(vec_at(vec, B, perm_k(t, q, 0), c0), vec_at(vec, B, perm_k(t, q, 1), c0),
                   vec_at(vec, B, perm_k(t, q, 2), c0), vec_at(vec, B, perm_k(t, q, 3), c0));
    a[t][1] = s8x4(vec_at(vec, B, perm_k(t, q, 0), c1), vec_at(vec, B, perm_k(t, q, 1), c1),
                   vec_at(vec, B, perm_k(t, q, 2), c1), vec_at(vec, B, perm_k(t, q, 3), c1));
  }
  for (int s = 0; s < steps; s++) {
    const uint32_t a01[4] = {a[0][0], a[0][1], a[1][0], a[1][1]};
    int d[CHAIN_NT][4];
#pragma unroll
    for (int nt = 0; nt < CHAIN_NT; nt++) {
      const uint32_t b01[2] = {bm[0][nt], bm[1][nt]};
      d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0;
      mma_s8_m16n8k32(d[nt], a01, b01);
      mma_s8_m16n8k16(d[nt], a[2], bm[2][nt]);
    }
#pragma unroll
    for (int t = 0; t < CHAIN_KS; t++) {
      a[t][0] = mask7x4(d[2 * t][0], d[2 * t][1], d[2 * t + 1][0], d[2 * t + 1][1]);
      a[t][1] = mask7x4(d[2 * t][2], d[2 * t][3], d[2 * t + 1][2], d[2 * t + 1][3]);
    }
  }
  // out (48, B): the state's bytes, sign-extended (acc0 = vec may be
  // negative), back to their rows
#pragma unroll
  for (int t = 0; t < CHAIN_KS; t++) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const size_t k = perm_k(t, q, i);
      if (c0 < B) out[k * B + c0] = (int8_t)(a[t][0] >> (8 * i));
      if (c1 < B) out[k * B + c1] = (int8_t)(a[t][1] >> (8 * i));
    }
  }
}

extern "C" int ph2_mma_int8_chain(const int8_t* mat, const int8_t* vec, int32_t* out, int B, int steps,
                                  void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) int8_chain_kernel<<<(B + 15) / 16, 32, 0, (cudaStream_t)stream>>>(mat, vec, out, B, steps);
  return (int)cudaGetLastError();
}
