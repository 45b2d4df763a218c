// Pairing-check kernel: replaces plutus_halo2_tpu/ops/pallas_pairing.py:419
// (make_pairing_check, pallas_call at :549).
//
// What it computes: for every row, e(el, Q1) * e(er, Q2) == 1, with el, er
// (B, 3, 25) projective Montgomery limbs and the G2 sides fixed per
// verifying key, given as host-prepared line ladders (2, 63, 4, 2, 12)
// (dbl_lam, dbl_c, add_lam, add_c per Miller step, kernel-domain words).
// Steps: projective -> affine by Fermat inversion; a 63-step Miller loop of
// sparse (w^0, w^2, w^3) line products (5 addition steps); the final
// exponentiation f^((p^6 - 1)(p^2 + 1)) then the hard part
// 3h = (x-1)^2 (x+p) (x^2+p^2-1) + 3 as five exp-by-x chains; an exact
// compare to 1. An identity input contributes the factor 1.
//
// Bound: integer multiply throughput. The function needs about 17,000 Fp
// products per row with two non-identity points, each a CIOS product of 300
// 32x32 word multiplies (~5.1e6 per row), counted by chip_smoke.py with the
// Pallas kernel's algorithm: Karatsuba Fp12 products (54), complex Miller
// squarings (36), cyclotomic squarings in the hard part (18), sparse lines
// (41), two Fermat inversions (485). This kernel does about 54,000: its
// tower is schoolbook (an Fp12 product or squaring is 108) everywhere.
//
// Design: one thread per row, all of the row's state in local memory
// (an Fp12 is 144 words, so it spills; slow is acceptable in this first
// version). Blocks of 64 threads: one-thread blocks, which spread 1024
// rows over every SM, ran 2x slower (PERF.md). The ladders are
// read with __ldg from global memory. The Fp12 functions are __noinline__
// and the 63-step loops rolled, so nvcc compiles the kernel in seconds.
#include "tower.cuh"

constexpr int MILLER_STEPS = 63;

DEV void load_fp2_line(Fp2& r, const uint32_t* lines, int pair, int step, int kind) {
  const uint32_t* src = lines + (((size_t)(pair * MILLER_STEPS + step) * 4 + kind) * 2) * 12;
  for (int w = 0; w < 12; w++) {
    r.a.w[w] = LDG(src + w);
    r.b.w[w] = LDG(src + 12 + w);
  }
}

struct G1Aff {
  Fp x, neg_y;
  bool inf;
};

// f *= the `kind` (0 = doubling, 2 = addition) line of every pair at `step`
DEV_NOINLINE void miller_lines(Fp12& f, const G1Aff* P, const uint32_t* lines, int step, int kind) {
#pragma unroll 1
  for (int j = 0; j < 2; j++) {
    if (P[j].inf) continue;  // e(O, Q) = 1: the line is 1
    Fp2 lam, c0, c2, c3;
    load_fp2_line(lam, lines, j, step, kind);
    load_fp2_line(c0, lines, j, step, kind + 1);
    fp2_mul_fp(c2, lam, P[j].x);
    c3.a = P[j].neg_y;
    fp_zero(c3.b);
    fp12_mul_sparse023(f, c0, c2, c3);
  }
}

// m^x for the negative BLS parameter x: square-and-multiply by |x|, then
// conjugate (the inverse in the cyclotomic subgroup)
DEV_NOINLINE void exp_by_neg_x(Fp12& r, const Fp12& m) {
  Fp12 acc = m;
#pragma unroll 1
  for (int bit = 62; bit >= 0; bit--) {
    fp12_sqr(acc, acc);
    if ((BLS_X_ABS >> bit) & 1) fp12_mul(acc, acc, m);
  }
  fp12_conj(r, acc);
}

DEV_NOINLINE bool final_exp_is_one(const Fp12& f) {
  Fp12 t, u, m, a, b, c, d;
  fp12_inv(u, f);
  fp12_conj(t, f);
  fp12_mul(t, t, u);  // f^(p^6 - 1)
  fp12_frobenius(u, t, 2);
  fp12_mul(m, u, t);  // ^(p^2 + 1)
  exp_by_neg_x(a, m);
  fp12_conj(u, m);
  fp12_mul(a, a, u);  // m^(x-1)
  exp_by_neg_x(b, a);
  fp12_conj(u, a);
  fp12_mul(b, b, u);  // m^((x-1)^2)
  exp_by_neg_x(c, b);
  fp12_frobenius(u, b, 1);
  fp12_mul(c, c, u);  // ^(x+p)
  exp_by_neg_x(d, c);
  exp_by_neg_x(d, d);  // c^(x^2)
  fp12_frobenius(u, c, 2);
  fp12_mul(d, d, u);
  fp12_conj(u, c);
  fp12_mul(d, d, u);  // ^(x^2 + p^2 - 1)
  fp12_sqr(u, m);
  fp12_mul(u, u, m);
  fp12_mul(d, d, u);  // * m^3
  return fp12_is_one(d);
}

DEV_NOINLINE void to_affine(G1Aff& r, const int64_t* limbs) {
  Fp X, Y, Z, zi;
  load_port<FpT>(X.w, limbs);
  load_port<FpT>(Y.w, limbs + 25);
  load_port<FpT>(Z.w, limbs + 50);
  r.inf = fp_is_zero(Z);
  fp_inv(zi, Z);
  fp_mul(r.x, X, zi);
  fp_mul(Y, Y, zi);
  fp_neg(r.neg_y, Y);
}

DEV bool pairing_row(const int64_t* el, const int64_t* er, const uint32_t* lines) {
  G1Aff P[2];
  to_affine(P[0], el);
  to_affine(P[1], er);
  Fp12 f;
  fp12_one(f);
#pragma unroll 1
  for (int i = 0; i < MILLER_STEPS; i++) {
    fp12_sqr(f, f);
    miller_lines(f, P, lines, i, 0);
    if ((BLS_X_ABS >> (62 - i)) & 1) miller_lines(f, P, lines, i, 2);
  }
  return final_exp_is_one(f);
}

__global__ void pairing_kernel(const int64_t* el, const int64_t* er, const uint32_t* lines, int* out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = pairing_row(el + (size_t)b * 75, er + (size_t)b * 75, lines) ? 1 : 0;
}

extern "C" int ph2_pairing_check(const int64_t* el, const int64_t* er, const uint32_t* lines, int* out,
                                 int B, int tpb, void* stream) {
  if (B > 0) {
    pairing_kernel<<<(B + tpb - 1) / tpb, tpb, 0, (cudaStream_t)stream>>>(el, er, lines, out, B);
  }
  return (int)cudaGetLastError();
}
