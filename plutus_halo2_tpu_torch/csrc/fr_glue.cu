// The verifier's Fr glue as elementwise kernels: one launch a field op
// (ops/cuda_fr.py), where the plain versions (ops/limb.py) issue 29-73 torch
// ops each. Replaces no Pallas kernel: the JAX package leaves these ops to
// XLA, which fuses them into its programs; here each became a graph node
// of its own, and ~480 such ops a batch were ~28,500 of a graph's ~34,000
// kernel nodes (PERF.md).
//
// What it computes, on the port's representation (int64 tensors (..., 17)
// of 16-bit limbs, Montgomery with R = 2^272, canonical out), each result
// the plain version's limb for limb:
//   fr_glue_mul  a b / 2^272 mod q (limb.mont_mul; with a constant operand
//                also to_mont and from_mont)
//   fr_glue_add  a + b mod q, fr_glue_sub  a - b mod q (limb.add, limb.sub)
//   fr_glue_sum  sum_k a_k mod q (limb.sum_lazy)
//   fr_glue_dot  sum_k a_k b_k / 2^272 mod q (limb.dot_lazy)
// Domain, as the plain versions document theirs: every limb in [0, 2^32);
// a product's operands with a b < q 2^272 (lazy limbs up to ~2^16 + 2^8,
// to_mont's values below 2^256); add and sub canonical; a sum below 2^288
// (raw sums of up to 2^15 canonical elements).
//
// Arithmetic. An operand's 17 limbs are read as one 288-bit value in nine
// 32-bit words (carries resolved: a lazy limb is exact). A product is a
// CIOS Montgomery product over nine words, a b / 2^288 mod q, exact and
// fully reduced for a b < q 2^288, then field.cuh's eight-word f_mul by
// 2^272 mod q (FR_FROM_K), which turns the divisor into 2^272. A sum adds
// the words of its terms in 64-bit accumulators and reduces the wide value
// once: the nine-word product by 2^288 mod q (FR_W288), or for a dot, whose
// terms are a_k b_k / 2^288, by 2^304 mod q (FR_W304). add and sub are
// field.cuh's f_add and f_sub. Every result is the canonical residue, so it
// equals the plain version's whatever the reduction's path. Plain C: no PTX
// carry chain, so the CPU simulation (tests/test_torch_group_sim.py) runs
// the card's arithmetic.
//
// Layout. The output is contiguous, (n, 17). An operand is read through its
// own strides (in int64 elements) over the output's three leading dims, 0
// where it broadcasts, and over the reduced dim: the glue's broadcasts
// ((B, 1, L) against (1, K, L), (B, L) against (L,)) and slices are read
// where they lie, with no copy. The wrapper coalesces the dims and makes
// the operands' limbs contiguous.
//
// Bound. A graph node's fixed cost: at the verifier's widths (1,024 to
// 36,864 elements) one op moves at most ~15 MB and needs ~300 word
// products an element, microseconds of either; the plain versions' time
// was their node count, not their width. So one thread an element, and no
// staging: a node's time is its latency, one element's chain of products.
#include "field.cuh"

constexpr int GW = FrT::NW + 1;       // words of a wide value: 288 bits
constexpr int GLUE_MAX_THREADS = 256;

// an operand: its first limb, and its strides over the output's leading
// dims 0-2 and the reduced dim (s[3])
struct GlueArg {
  const int64_t* p;
  int64_t s[4];
};

// the launch: n output elements over leading dims (n / (d1 d2), d1, d2), k
// terms a sum (each below 2^31: 32-bit index arithmetic)
struct GlueGeom {
  GlueArg a, b;
  unsigned n, d1, d2, k;
};

DEV uint32_t glue_mod(int j) { return j < FrT::NW ? FrT::mod(j) : 0u; }

// 17 limbs (each below 2^32) -> the value's nine words (exact below 2^288)
DEV void glue_load(uint32_t* w, const int64_t* x) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < GW; j++) {
    c += (uint64_t)(uint32_t)x[2 * j];
    if (2 * j + 1 < FrT::L16) c += (uint64_t)(uint32_t)x[2 * j + 1] << 16;
    w[j] = (uint32_t)c;
    c >>= 32;
  }
}

// a canonical value's eight words -> 17 limbs
DEV void glue_store(int64_t* y, const uint32_t* r) {
#pragma unroll
  for (int i = 0; i < FrT::NW; i++) {
    y[2 * i] = r[i] & 0xffffu;
    y[2 * i + 1] = r[i] >> 16;
  }
  y[FrT::L16 - 1] = 0;
}

// r = a b / 2^288 mod q, canonical, for nine-word a, b with a b < q 2^288.
// After the step of word i, t < b + q (below 2^289), so eleven words hold
// it and its products.
DEV void glue_mont(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[GW + 2];
#pragma unroll
  for (int i = 0; i < GW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < GW; i++) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < GW; j++) {
      const uint64_t s = (uint64_t)a[i] * b[j] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[GW] + C;
    t[GW] = (uint32_t)s;
    t[GW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * FrT::n0();
    s = (uint64_t)m * glue_mod(0) + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < GW; j++) {
      s = (uint64_t)m * glue_mod(j) + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[GW] + C;
    t[GW - 1] = (uint32_t)s;
    t[GW] = t[GW + 1] + (uint32_t)(s >> 32);
  }
  f_reduce_once<FrT>(r, t);  // t < 2q: its words 8 and 9 are 0
}

// r = x c / 2^288 mod q for a wide x and one of the eight-word constants
DEV void glue_mont_const(uint32_t* r, const uint32_t* x, const uint32_t* c8) {
  uint32_t c[GW];
#pragma unroll
  for (int j = 0; j < GW; j++) c[j] = j < FrT::NW ? c8[j] : 0u;
  glue_mont(r, x, c);
}

// the element's product a b / 2^272 mod q
DEV void glue_mul(uint32_t* r, const int64_t* pa, const int64_t* pb) {
  uint32_t x[GW], y[GW], c[FrT::NW];
  glue_load(x, pa);
  glue_load(y, pb);
  glue_mont(r, x, y);
#pragma unroll
  for (int i = 0; i < FrT::NW; i++) c[i] = FrT::from_k(i);  // 2^272 mod q
  f_mul<FrT>(r, r, c);
}

// the wide sum of 64-bit word accumulators (carries resolved; the value is
// below 2^288 in the domain)
DEV void glue_carry(uint32_t* x, const uint64_t* acc) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < GW; j++) {
    c += acc[j];
    x[j] = (uint32_t)c;
    c >>= 32;
  }
}

// this thread's output element, or -1 past the end; its operands' limbs
DEV int64_t glue_index(const GlueGeom& g, const int64_t** pa, const int64_t** pb) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n) return -1;
  const unsigned i2 = i % g.d2, r = i / g.d2, i1 = r % g.d1, i0 = r / g.d1;
  *pa = g.a.p + i0 * g.a.s[0] + i1 * g.a.s[1] + i2 * g.a.s[2];
  *pb = g.b.p + i0 * g.b.s[0] + i1 * g.b.s[1] + i2 * g.b.s[2];
  return i;
}

__global__ void __launch_bounds__(GLUE_MAX_THREADS) fr_glue_mul(GlueGeom g, int64_t* out) {
  const int64_t *pa, *pb;
  const int64_t i = glue_index(g, &pa, &pb);
  if (i < 0) return;
  uint32_t r[FrT::NW];
  glue_mul(r, pa, pb);
  glue_store(out + i * FrT::L16, r);
}

__global__ void __launch_bounds__(GLUE_MAX_THREADS) fr_glue_add(GlueGeom g, int64_t* out) {
  const int64_t *pa, *pb;
  const int64_t i = glue_index(g, &pa, &pb);
  if (i < 0) return;
  uint32_t x[GW], y[GW], r[FrT::NW];
  glue_load(x, pa);
  glue_load(y, pb);
  f_add<FrT>(r, x, y);
  glue_store(out + i * FrT::L16, r);
}

__global__ void __launch_bounds__(GLUE_MAX_THREADS) fr_glue_sub(GlueGeom g, int64_t* out) {
  const int64_t *pa, *pb;
  const int64_t i = glue_index(g, &pa, &pb);
  if (i < 0) return;
  uint32_t x[GW], y[GW], r[FrT::NW];
  glue_load(x, pa);
  glue_load(y, pb);
  f_sub<FrT>(r, x, y);
  glue_store(out + i * FrT::L16, r);
}

__global__ void __launch_bounds__(GLUE_MAX_THREADS) fr_glue_sum(GlueGeom g, int64_t* out) {
  const int64_t *pa, *pb;
  const int64_t i = glue_index(g, &pa, &pb);
  if (i < 0) return;
  uint64_t acc[GW] = {};
  uint32_t x[GW], r[FrT::NW];
  for (unsigned k = 0; k < g.k; k++) {
    glue_load(x, pa + k * g.a.s[3]);
#pragma unroll
    for (int j = 0; j < GW; j++) acc[j] += x[j];
  }
  glue_carry(x, acc);
  glue_mont_const(r, x, FR_W288);  // x 2^288 / 2^288
  glue_store(out + i * FrT::L16, r);
}

__global__ void __launch_bounds__(GLUE_MAX_THREADS) fr_glue_dot(GlueGeom g, int64_t* out) {
  const int64_t *pa, *pb;
  const int64_t i = glue_index(g, &pa, &pb);
  if (i < 0) return;
  uint64_t acc[GW] = {};
  uint32_t x[GW], y[GW], r[FrT::NW];
  for (unsigned k = 0; k < g.k; k++) {
    glue_load(x, pa + k * g.a.s[3]);
    glue_load(y, pb + k * g.b.s[3]);
    glue_mont(r, x, y);  // a_k b_k / 2^288, below q
#pragma unroll
    for (int j = 0; j < FrT::NW; j++) acc[j] += r[j];
  }
  glue_carry(x, acc);
  glue_mont_const(r, x, FR_W304);  // (sum a_k b_k / 2^288) 2^304 / 2^288
  glue_store(out + i * FrT::L16, r);
}

// op: 0 mul, 1 add, 2 sub, 3 sum, 4 dot (cuda_fr.OPS). geom (host memory,
// 12 values): n, d1, d2, k, then a's and b's strides (dims 0-2, reduced).
// threads: a multiple of 32 up to GLUE_MAX_THREADS. No launch for n = 0.
extern "C" int ph2_fr_glue(int op, const int64_t* a, const int64_t* b, int64_t* out, const int64_t* geom,
                           int threads, void* stream) {
  if (threads < 32 || threads > GLUE_MAX_THREADS || threads % 32 || op < 0 || op > 4)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < 4; j++)
    if (geom[j] < (j == 0 || j == 3 ? 0 : 1) || geom[j] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (geom[0] == 0) return 0;
  GlueGeom g;
  g.n = (unsigned)geom[0];
  g.d1 = (unsigned)geom[1];
  g.d2 = (unsigned)geom[2];
  g.k = (unsigned)geom[3];
  g.a.p = a;
  g.b.p = b;
  for (int j = 0; j < 4; j++) {
    g.a.s[j] = geom[4 + j];
    g.b.s[j] = geom[8 + j];
  }
  const unsigned blocks = (g.n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case 0: fr_glue_mul<<<blocks, threads, 0, st>>>(g, out); break;
    case 1: fr_glue_add<<<blocks, threads, 0, st>>>(g, out); break;
    case 2: fr_glue_sub<<<blocks, threads, 0, st>>>(g, out); break;
    case 3: fr_glue_sum<<<blocks, threads, 0, st>>>(g, out); break;
    default: fr_glue_dot<<<blocks, threads, 0, st>>>(g, out); break;
  }
  return (int)cudaGetLastError();
}
