// Shared BLS12-381 G1 device code for the curve kernels: projective points
// over the kernel's Fp domain (field.cuh), one thread's complete RCB15
// formulas (a = 0, b3 = 12), and the one-thread-per-point form of the
// per-row random-weighted aggregate subgroup test that
// plutus_halo2_tpu/ops/pallas_curve.py:642 (make_subgroup_kernel) computes,
// run by subgroup.cu. The MSM and the fused decompress kernel run the lane-
// group forms of group.cuh on top of this file.
//
// The aggregate test (the port of ops/curve.aggregate_subgroup_check):
// per row and round, Q = sum_k w_k P_k with verifier-chosen weights
// w_k in [1, 2^16), then P in G1 <=> phi(P) == [z^2 - 1] P with
// phi(x, y) = (beta x, y) (Bowe 2019), the identity counting as a member.
// The verdict depends only on the points and the weights: Q is the same
// point whichever way it is summed, and the test is projective-invariant.
// Functions outside field.cuh's templates are static: every kernel source
// is its own translation unit.
#pragma once
#include "field.cuh"

struct Pt {
  uint32_t x[12], y[12], z[12];
};

DEV void pt_identity(Pt& p) {
  f_zero<FpT>(p.x);
  f_one<FpT>(p.y);
  f_zero<FpT>(p.z);
}

// 3 b = 12 in the kernel's Montgomery domain: 12 R mod p = 12 * one
DEV void b3_times(uint32_t* r, const uint32_t* a) {
  uint32_t t2[12], t4[12], t8[12];
  f_add<FpT>(t2, a, a);
  f_add<FpT>(t4, t2, t2);
  f_add<FpT>(t8, t4, t4);
  f_add<FpT>(r, t8, t4);
}

// Complete addition, RCB15 Algorithm 7 (a = 0); r may alias p or q.
static DEV_NOINLINE void pt_add(Pt& r, const Pt& p, const Pt& q) {
  uint32_t t0[12], t1[12], t2[12], t3[12], t4[12], X3[12], Y3[12], Z3[12];
  f_mul<FpT>(t0, p.x, q.x);
  f_mul<FpT>(t1, p.y, q.y);
  f_mul<FpT>(t2, p.z, q.z);
  f_add<FpT>(t3, p.x, p.y);
  f_add<FpT>(t4, q.x, q.y);
  f_mul<FpT>(t3, t3, t4);
  f_add<FpT>(t4, t0, t1);
  f_sub<FpT>(t3, t3, t4);
  f_add<FpT>(t4, p.y, p.z);
  f_add<FpT>(X3, q.y, q.z);
  f_mul<FpT>(t4, t4, X3);
  f_add<FpT>(X3, t1, t2);
  f_sub<FpT>(t4, t4, X3);
  f_add<FpT>(X3, p.x, p.z);
  f_add<FpT>(Y3, q.x, q.z);
  f_mul<FpT>(X3, X3, Y3);
  f_add<FpT>(Y3, t0, t2);
  f_sub<FpT>(Y3, X3, Y3);
  f_add<FpT>(X3, t0, t0);
  f_add<FpT>(t0, X3, t0);
  b3_times(t2, t2);
  f_add<FpT>(Z3, t1, t2);
  f_sub<FpT>(t1, t1, t2);
  b3_times(Y3, Y3);
  f_mul<FpT>(X3, t4, Y3);
  f_mul<FpT>(t2, t3, t1);
  f_sub<FpT>(X3, t2, X3);
  f_mul<FpT>(Y3, Y3, t0);
  f_mul<FpT>(t1, t1, Z3);
  f_add<FpT>(Y3, t1, Y3);
  f_mul<FpT>(t0, t0, t3);
  f_mul<FpT>(Z3, Z3, t4);
  f_add<FpT>(Z3, Z3, t0);
  f_copy<FpT>(r.x, X3);
  f_copy<FpT>(r.y, Y3);
  f_copy<FpT>(r.z, Z3);
}

// Complete doubling, RCB15 Algorithm 9 (a = 0); r may alias p.
static DEV_NOINLINE void pt_double(Pt& r, const Pt& p) {
  uint32_t t0[12], t1[12], t2[12], X3[12], Y3[12], Z3[12];
  f_mul<FpT>(t0, p.y, p.y);
  f_add<FpT>(Z3, t0, t0);
  f_add<FpT>(Z3, Z3, Z3);
  f_add<FpT>(Z3, Z3, Z3);
  f_mul<FpT>(t1, p.y, p.z);
  f_mul<FpT>(t2, p.z, p.z);
  b3_times(t2, t2);
  f_mul<FpT>(X3, t2, Z3);
  f_add<FpT>(Y3, t0, t2);
  f_mul<FpT>(Z3, t1, Z3);
  f_add<FpT>(t1, t2, t2);
  f_add<FpT>(t2, t1, t2);
  f_sub<FpT>(t0, t0, t2);
  f_mul<FpT>(Y3, t0, Y3);
  f_add<FpT>(Y3, X3, Y3);
  f_mul<FpT>(t1, p.x, p.y);
  f_mul<FpT>(X3, t0, t1);
  f_add<FpT>(X3, X3, X3);
  f_copy<FpT>(r.x, X3);
  f_copy<FpT>(r.y, Y3);
  f_copy<FpT>(r.z, Z3);
}

DEV void pt_load_port(Pt& p, const int64_t* src) {
  load_port<FpT>(p.x, src);
  load_port<FpT>(p.y, src + 25);
  load_port<FpT>(p.z, src + 50);
}

DEV void pt_store_port(int64_t* dst, const Pt& p) {
  store_port<FpT>(dst, p.x);
  store_port<FpT>(dst + 25, p.y);
  store_port<FpT>(dst + 50, p.z);
}

// ---- the aggregate subgroup test -------------------------------------------

// The weights are below 2^16: signed 3-bit windows (digits in [-4, 4], the
// sign a free Y negation) over a 5-entry table [0P .. 4P]; 6 windows cover
// the 16 bits plus the recoding carry, and the top window never carries.
constexpr int SUB_WBITS = 3, SUB_NWIN = 6, SUB_TENT = 5;

// r = [w] P for 0 < w < 2^16: 3 table additions, 18 doublings, 6 additions.
static DEV_NOINLINE void pt_mul_weight(Pt& r, const Pt& P, uint32_t w) {
  Pt tab[SUB_TENT];
  pt_identity(tab[0]);
  tab[1] = P;
#pragma unroll 1
  for (int k = 2; k < SUB_TENT; k++) pt_add(tab[k], tab[k - 1], P);
  uint8_t mag[SUB_NWIN], neg[SUB_NWIN];
  int carry = 0;
#pragma unroll
  for (int i = 0; i < SUB_NWIN; i++) {
    const int d = (int)((w >> (SUB_WBITS * i)) & 7) + carry;
    carry = d > 4;
    mag[i] = carry ? 8 - d : d;
    neg[i] = carry;
  }
  Pt acc, t;
  pt_identity(acc);
#pragma unroll 1
  for (int i = SUB_NWIN - 1; i >= 0; i--) {
#pragma unroll 1
    for (int k = 0; k < SUB_WBITS; k++) pt_double(acc, acc);
    t = tab[mag[i]];
    if (neg[i]) f_neg<FpT>(t.y, t.y);
    pt_add(acc, acc, t);
  }
  r = acc;
}

// r = [|z|] P, |z| = BLS_X_ABS MSB first: 63 doublings and 5 additions.
static DEV_NOINLINE void pt_mul_z_abs(Pt& r, const Pt& P) {
  Pt acc = P;
#pragma unroll 1
  for (int i = 62; i >= 0; i--) {
    pt_double(acc, acc);
    if ((BLS_X_ABS >> i) & 1) pt_add(acc, acc, P);
  }
  r = acc;
}

// P in G1 <=> phi(P) == [z^2 - 1] P (the sign of z squares away); the
// identity is a member. Projective equality by cross products, as
// ops/curve.eq: both finite and equal, or both the identity.
static DEV_NOINLINE bool pt_in_g1(const Pt& Q) {
  if (f_is_zero<FpT>(Q.z)) return true;
  Pt t, nq = Q;
  pt_mul_z_abs(t, Q);
  pt_mul_z_abs(t, t);
  f_neg<FpT>(nq.y, nq.y);
  pt_add(t, t, nq);  // [z^2 - 1] Q
  if (f_is_zero<FpT>(t.z)) return false;
  uint32_t phx[12], a[12], b[12];
  f_mul<FpT>(phx, Q.x, FP_BETA);
  f_mul<FpT>(a, phx, t.z);
  f_mul<FpT>(b, t.x, Q.z);
  if (!f_eq<FpT>(a, b)) return false;
  f_mul<FpT>(a, Q.y, t.z);
  f_mul<FpT>(b, t.y, Q.z);
  return f_eq<FpT>(a, b);
}

// Row layout of the aggregate kernels: KP = K rounded up to a power of two
// lanes per row, `rows` rows per block; lane k holds point k (the identity
// on lanes >= K and rows >= B). For each round every lane forms [w_k] P_k,
// a halving tree in shared memory (part: one Pt per thread) sums the row,
// and lane 0 tests the aggregate; the row's verdict is the AND over rounds.
// Every thread of the block must call this (it synchronises the block).
DEV bool row_aggregate_ok(Pt* part, const Pt& P, bool live, int lane, int KP, int K,
                          const int* weights, int rounds) {
  bool ok = true;
#pragma unroll 1
  for (int r = 0; r < rounds; r++) {
    Pt acc;
    if (live && lane < K) {
      pt_mul_weight(acc, P, (uint32_t)LDG(weights + r * K + lane));
    } else {
      pt_identity(acc);
    }
    part[threadIdx.x] = acc;
    __syncthreads();
#pragma unroll 1
    for (int st = KP / 2; st >= 1; st >>= 1) {
      if (lane < st) pt_add(part[threadIdx.x], part[threadIdx.x], part[threadIdx.x + st]);
      __syncthreads();
    }
    if (lane == 0 && live) ok = ok && pt_in_g1(part[threadIdx.x]);
    __syncthreads();  // part is rewritten by the next round
  }
  return ok;
}

// Launch shape of the row layout: rows per block from the caller's
// threads-per-block hint (at least one row), and the power-of-two lanes.
struct RowShape {
  int KP, rows, threads, blocks;
  size_t shmem;
};

static inline RowShape row_shape(int B, int K, int tpb) {
  RowShape s;
  s.KP = 1;
  while (s.KP < K) s.KP <<= 1;
  s.rows = tpb > s.KP ? tpb / s.KP : 1;
  s.threads = s.KP * s.rows;
  s.blocks = (B + s.rows - 1) / s.rows;
  s.shmem = (size_t)s.threads * sizeof(Pt);
  return s;
}
