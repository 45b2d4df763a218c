// G1 arithmetic on a row's lane group, shared by the MSM kernel (msm.cu),
// the fused decompress kernel (decompress.cu) and the subgroup kernel
// (subgroup.cu).
//
// A row of work belongs to a group of G lanes (G divides 32; the lanes of
// one warp, synchronised by __syncwarp on the group's mask) and to its
// slice of shared memory. A projective point is 36 words there (the X, Y,
// Z slots of 12 words each, in the kernel's Montgomery domain, 16-byte
// aligned). A point operation runs on n independent items at once as two
// stages of independent Fp products spread over the group's lanes, a group
// barrier after each stage. The complete formulas are RCB15's (a = 0,
// b3 = 12), staged as ops/curve.py stages them:
//   addition  stage 1: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
//             stage 2: t4 y3', t3 t1' | y3' t0', t1' z3 | t0' t3, z3 t4
//             -> X3 = t3 t1' - t4 y3', Y3 = t1' z3 + y3' t0', Z3 = z3 t4 + t0' t3
//   doubling  stage 1: YY, YZ, ZZ, XY
//             stage 2: t2' z8, t0' y3 | YZ z8, t0' XY
//             -> Y3 = t2' z8 + t0' y3, Z3 = YZ z8, X3 = 2 t0' XY
// with the linear parts folded into the products that read them. Stage 1
// writes its products to the item's scratch; stage 2 reads only scratch, so
// an output may alias an input. Many items (a row's window sums, its
// tables) take two products a lane in each stage, in batches of GROUP_NB
// (the scratch's size), stage 2 writing the output coordinates itself. A
// few items (a chain's, a ladder's: all products of all items fit on the
// lanes) take one product a lane, the latency of one product a stage, and a
// short linear stage combines stage 2's products (tools/curve_probe.py on an H100:
// two products in one lane take 2.3x the cycles of one). The stage
// functions are __noinline__, so each source compiles each of them once
// and its call sites only hand out units: inlined at every call site they
// made nvcc take ~100 s.
//
// On top of these: the per-point tables of multiples, the window sums over
// a row's points (one item per window, a term added per point), the one
// doubling chain over a row's window sums, and the aggregate subgroup test
// (group_aggregate_ok), whose z-ladders run for all rounds at once. Adds and
// subtractions run as PTX carry chains (field.cuh, fp_add_cc, fp_sub_cc).
#pragma once
#include <algorithm>

#include "curve.cuh"  // FpT, f_*, f_mul2, fp_*_cc, FP_BETA, BLS_X_ABS

constexpr int SLOT = 12;         // words of an Fp slot
constexpr int PT = 3 * SLOT;     // words of a projective point
constexpr int ADD_SCRATCH = 6 * SLOT;  // words of scratch per item (two products a lane)
constexpr int GROUP_NB = 32;     // items per batch

struct Group {
  int lane, G;
  unsigned mask;
  DEV void sync() const { __syncwarp(mask); }
};

// This thread's group of G lanes (consecutive threads).
DEV Group make_group(int G) {
  const int lane = threadIdx.x % G;
  const unsigned mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  return Group{lane, G, mask};
}

// Rows per block of a lane-group kernel of `lanes` lanes a row with
// `row_bytes` of shared memory a row: the fewest that put every row in one
// wave of blocks, one block per SM; at most 256 threads and what a block's
// shared memory holds. 0 when not one row fits.
static inline int group_rows(int B, int lanes, size_t row_bytes) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int fit = std::min((int)(smem_max / row_bytes), 256 / lanes);
  return fit < 1 ? 0 : std::max(1, std::min((B + sms - 1) / sms, fit));
}

DEV void s_load(uint32_t* r, const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 3; k++) {
    const uint4 v = q[k];
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

DEV void s_store(uint32_t* p, const uint32_t* r) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < 3; k++) q[k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

// (0 : 1 : 0), the 36 words written by the group's lanes (no barrier)
DEV void group_identity(const Group& g, uint32_t* p, int n) {
  for (int w = g.lane; w < n * PT; w += g.G) {
    const int c = w % PT;
    p[w] = c / SLOT == 1 ? FpT::one(c % SLOT) : 0u;
  }
}

// dst[i] = src[i] for n points (no barrier)
DEV void group_copy(const Group& g, uint32_t* dst, const uint32_t* src, int n) {
  for (int w = g.lane; w < n * PT; w += g.G) dst[w] = src[w];
}

// r = p - a (0 for a = 0), and r = 12 a (3 b, b = 4): PTX carry chains
DEV void fp_neg_cc(uint32_t* r, const uint32_t* a) {
  uint32_t z[SLOT];
  f_zero<FpT>(z);
  fp_sub_cc(r, z, a);
}

DEV void times12(uint32_t* r, const uint32_t* a) {
  uint32_t t4[SLOT];
  fp_add_cc(t4, a, a);
  fp_add_cc(t4, t4, t4);
  fp_add_cc(r, t4, t4);
  fp_add_cc(r, r, t4);  // 8 a + 4 a
}

// One item of a point operation: dst = a + (neg ? -b : b) (an addition) or
// dst = 2 a (a doubling, b unused); a dead item is skipped.
struct Item {
  uint32_t* dst;
  const uint32_t* a;
  const uint32_t* b;
  bool neg, live;
};

// r = coordinate i of P, plus coordinate j when j >= 0; Y negated if negy
DEV void coord_sum(uint32_t* r, const uint32_t* P, int i, int j, bool negy) {
  s_load(r, P + SLOT * i);
  if (negy && i == 1) fp_neg_cc(r, r);
  if (j >= 0) {
    uint32_t v[SLOT];
    s_load(v, P + SLOT * j);
    if (negy && j == 1) fp_neg_cc(v, v);
    fp_add_cc(r, r, v);
  }
}

// addition stage 1, unit k of 3: products 2k and 2k + 1 of
// (X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)) to t
static DEV_NOINLINE void add_stage1(int k, const uint32_t* A, const uint32_t* B, bool neg, uint32_t* t) {
  const int i0 = k == 0 ? 0 : k == 1 ? 2 : 1, j0 = k == 2 ? 2 : -1;
  const int i1 = k == 0 ? 1 : 0, j1 = k == 0 ? -1 : k == 1 ? 1 : 2;
  uint32_t a0[SLOT], b0[SLOT], a1[SLOT], b1[SLOT];
  coord_sum(a0, A, i0, j0, false);
  coord_sum(b0, B, i0, j0, neg);
  coord_sum(a1, A, i1, j1, false);
  coord_sum(b1, B, i1, j1, neg);
  f_mul2<FpT>(a0, a0, b0, a1, a1, b1);
  s_store(t + SLOT * (2 * k), a0);
  s_store(t + SLOT * (2 * k + 1), a1);
}

// addition stage 2, unit k of 3: output coordinate k from t (t0 t1 t2 m0 m1 m2)
static DEV_NOINLINE void add_stage2(int k, const uint32_t* t, uint32_t* dst) {
  uint32_t t0[SLOT], t1[SLOT], t2[SLOT], u[SLOT], a0[SLOT], b0[SLOT], a1[SLOT], b1[SLOT];
  s_load(t0, t);
  s_load(t1, t + SLOT);
  s_load(t2, t + 2 * SLOT);
  times12(t2, t2);  // t2' = 12 t2
  // t1' = t1 - t2', z3 = t1 + t2', t0' = 3 t0
  if (k == 0) {  // X3 = t3 t1' - t4 y3'
    s_load(u, t + 3 * SLOT);  // m0
    fp_sub_cc(a0, u, t0);
    fp_sub_cc(a0, a0, t1);  // t3
    fp_sub_cc(b0, t1, t2);  // t1'
    s_load(u, t + 4 * SLOT);  // m1
    s_load(b1, t + 2 * SLOT);  // t2
    fp_sub_cc(a1, u, t1);
    fp_sub_cc(a1, a1, b1);  // t4
    s_load(u, t + 5 * SLOT);  // m2
    fp_sub_cc(u, u, t0);
    fp_sub_cc(u, u, b1);
    times12(b1, u);  // y3'
  } else if (k == 1) {  // Y3 = t1' z3 + y3' t0'
    fp_sub_cc(a0, t1, t2);  // t1'
    fp_add_cc(b0, t1, t2);  // z3
    s_load(u, t + 5 * SLOT);  // m2
    s_load(b1, t + 2 * SLOT);  // t2
    fp_sub_cc(u, u, t0);
    fp_sub_cc(u, u, b1);
    times12(a1, u);  // y3'
    fp_add_cc(b1, t0, t0);
    fp_add_cc(b1, b1, t0);  // t0'
  } else {  // Z3 = z3 t4 + t0' t3
    fp_add_cc(a0, t1, t2);  // z3
    s_load(u, t + 4 * SLOT);  // m1
    s_load(b1, t + 2 * SLOT);  // t2
    fp_sub_cc(b0, u, t1);
    fp_sub_cc(b0, b0, b1);  // t4
    fp_add_cc(a1, t0, t0);
    fp_add_cc(a1, a1, t0);  // t0'
    s_load(u, t + 3 * SLOT);  // m0
    fp_sub_cc(b1, u, t0);
    fp_sub_cc(b1, b1, t1);  // t3
  }
  f_mul2<FpT>(a0, a0, b0, a1, a1, b1);
  if (k == 0)
    fp_sub_cc(a0, a0, a1);
  else
    fp_add_cc(a0, a0, a1);
  s_store(dst + SLOT * k, a0);
}

// doubling stage 1, unit k of 2: (YY, YZ) or (ZZ, XY) to t
static DEV_NOINLINE void dbl_stage1(int k, const uint32_t* P, uint32_t* t) {
  uint32_t a0[SLOT], b0[SLOT], a1[SLOT], b1[SLOT];
  s_load(a0, P + SLOT * (k == 0 ? 1 : 2));
  s_load(b0, P + SLOT * (k == 0 ? 1 : 2));
  s_load(a1, P + SLOT * (k == 0 ? 1 : 0));
  s_load(b1, P + SLOT * (k == 0 ? 2 : 1));
  f_mul2<FpT>(a0, a0, b0, a1, a1, b1);
  s_store(t + SLOT * (2 * k), a0);
  s_store(t + SLOT * (2 * k + 1), a1);
}

// doubling stage 2, unit k of 2, from t (YY YZ ZZ XY): Y3, or Z3 and X3
static DEV_NOINLINE void dbl_stage2(int k, const uint32_t* t, uint32_t* dst) {
  uint32_t s0[SLOT], t2[SLOT], u[SLOT], a0[SLOT], b0[SLOT], a1[SLOT], b1[SLOT];
  s_load(s0, t);
  s_load(t2, t + 2 * SLOT);
  times12(t2, t2);  // t2' = 12 ZZ
  fp_add_cc(u, t2, t2);
  fp_add_cc(u, u, t2);
  fp_sub_cc(u, s0, u);  // t0' = YY - 3 t2'
  fp_add_cc(b0, s0, s0);
  fp_add_cc(b0, b0, b0);
  fp_add_cc(b0, b0, b0);  // z8 = 8 YY
  if (k == 0) {  // Y3 = t2' z8 + t0' (YY + t2')
    f_copy<FpT>(a0, t2);
    f_copy<FpT>(a1, u);
    fp_add_cc(b1, s0, t2);
  } else {  // Z3 = YZ z8, X3 = 2 t0' XY
    s_load(a0, t + SLOT);
    f_copy<FpT>(a1, u);
    s_load(b1, t + 3 * SLOT);
  }
  f_mul2<FpT>(a0, a0, b0, a1, a1, b1);
  if (k == 0) {
    fp_add_cc(a0, a0, a1);
    s_store(dst + SLOT, a0);
  } else {
    s_store(dst + 2 * SLOT, a0);
    fp_add_cc(a1, a1, a1);
    s_store(dst, a1);
  }
}

// ---- one product a lane: the few-item form ---------------------------------
// Where every product of every item fits on the group's lanes at once (a
// chain's one to four items), a lane takes one product, not two: stage 1
// and stage 2 write their products to the item's scratch (t, then p, 6
// slots each), and a short linear stage combines p into the output.

enum { LIN_T3, LIN_T4, LIN_Y3, LIN_T0, LIN_Z3, LIN_T1 };  // t3, t4, y3', t0', z3, t1'

// one linear value of addition stage 2 from t (t0 t1 t2 m0 m1 m2)
DEV void add_lin(uint32_t* r, int which, const uint32_t* t) {
  uint32_t u[SLOT], v[SLOT];
  if (which == LIN_T3 || which == LIN_T4) {  // m0 - t0 - t1, m1 - t1 - t2
    const int o = which == LIN_T3 ? 0 : 1;
    s_load(r, t + SLOT * (3 + o));
    s_load(u, t + SLOT * o);
    fp_sub_cc(r, r, u);
    s_load(u, t + SLOT * (1 + o));
    fp_sub_cc(r, r, u);
  } else if (which == LIN_Y3) {  // 12 (m2 - t0 - t2)
    s_load(u, t + 5 * SLOT);
    s_load(v, t);
    fp_sub_cc(u, u, v);
    s_load(v, t + 2 * SLOT);
    fp_sub_cc(u, u, v);
    times12(r, u);
  } else if (which == LIN_T0) {  // 3 t0
    s_load(u, t);
    fp_add_cc(r, u, u);
    fp_add_cc(r, r, u);
  } else {  // t1 + 12 t2, t1 - 12 t2
    s_load(u, t + 2 * SLOT);
    times12(u, u);
    s_load(v, t + SLOT);
    if (which == LIN_Z3)
      fp_add_cc(r, v, u);
    else
      fp_sub_cc(r, v, u);
  }
}

// addition stage 1, product k of 6 (X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2),
// (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)) to t[k]
static DEV_NOINLINE void add_single1(int k, const uint32_t* A, const uint32_t* B, bool neg, uint32_t* t) {
  const int i = k == 1 || k == 4 ? 1 : k == 2 ? 2 : 0;
  const int j = k == 3 ? 1 : k == 4 || k == 5 ? 2 : -1;
  uint32_t a[SLOT], b[SLOT];
  coord_sum(a, A, i, j, false);
  coord_sum(b, B, i, j, neg);
  f_mul<FpT>(a, a, b);
  s_store(t + SLOT * k, a);
}

// addition stage 2, product k of 6 (t4 y3', t3 t1', y3' t0', t1' z3, t0' t3, z3 t4) to p[k]
static DEV_NOINLINE void add_single2(int k, const uint32_t* t, uint32_t* p) {
  const int la = k == 0 ? LIN_T4 : k == 1 ? LIN_T3 : k == 2 ? LIN_Y3 : k == 3 ? LIN_T1 : k == 4 ? LIN_T0 : LIN_Z3;
  const int lb = k == 0 ? LIN_Y3 : k == 1 ? LIN_T1 : k == 2 ? LIN_T0 : k == 3 ? LIN_Z3 : k == 4 ? LIN_T3 : LIN_T4;
  uint32_t a[SLOT], b[SLOT];
  add_lin(a, la, t);
  add_lin(b, lb, t);
  f_mul<FpT>(a, a, b);
  s_store(p + SLOT * k, a);
}

// doubling stage 1, product k of 4 (YY, YZ, ZZ, XY) to t[k]
static DEV_NOINLINE void dbl_single1(int k, const uint32_t* P, uint32_t* t) {
  uint32_t a[SLOT], b[SLOT];
  s_load(a, P + SLOT * (k == 2 ? 2 : k == 3 ? 0 : 1));
  s_load(b, P + SLOT * (k == 0 || k == 3 ? 1 : 2));
  f_mul<FpT>(a, a, b);
  s_store(t + SLOT * k, a);
}

// doubling stage 2, product k of 4 (t2' z8, YZ z8, t0' y3, t0' XY) to p[k]
static DEV_NOINLINE void dbl_single2(int k, const uint32_t* t, uint32_t* p) {
  uint32_t a[SLOT], b[SLOT], u[SLOT], v[SLOT];
  s_load(u, t);  // YY
  s_load(v, t + 2 * SLOT);
  times12(v, v);  // t2' = 12 ZZ
  if (k < 2) {
    fp_add_cc(b, u, u);
    fp_add_cc(b, b, b);
    fp_add_cc(b, b, b);  // z8 = 8 YY
    if (k == 0)
      f_copy<FpT>(a, v);
    else
      s_load(a, t + SLOT);
  } else {
    fp_add_cc(a, v, v);
    fp_add_cc(a, a, v);
    fp_sub_cc(a, u, a);  // t0' = YY - 3 t2'
    if (k == 2)
      fp_add_cc(b, u, v);  // y3 = YY + t2'
    else
      s_load(b, t + 3 * SLOT);
  }
  f_mul<FpT>(a, a, b);
  s_store(p + SLOT * k, a);
}

// output coordinate c from stage 2's products p: an addition's
// (p1 - p0, p3 + p2, p5 + p4), a doubling's (2 p3, p0 + p2, p1)
static DEV_NOINLINE void combine(int c, bool dbl, const uint32_t* p, uint32_t* dst) {
  uint32_t a[SLOT], b[SLOT];
  const int i = dbl ? (c == 0 ? 3 : c == 1 ? 0 : 1) : 2 * c + 1;
  const int j = dbl ? (c == 0 ? 3 : c == 1 ? 2 : -1) : 2 * c;
  s_load(a, p + SLOT * i);
  if (j >= 0) {
    s_load(b, p + SLOT * j);
    if (!dbl && c == 0)
      fp_sub_cc(a, a, b);
    else
      fp_add_cc(a, a, b);
  }
  s_store(dst + SLOT * c, a);
}

constexpr int SINGLE_SCRATCH = 12 * SLOT;  // words of scratch per item: t and p

// n operations by single-product units (n * units <= G); ends with a barrier
template <class Items>
DEV void group_single(const Group& g, uint32_t* scratch, int n, bool dbl, Items items) {
  const int U = dbl ? 4 : 6;
  const int u = g.lane, i = u / U, k = u % U;
  uint32_t* t = scratch + SINGLE_SCRATCH * i;
  const bool mine = u < U * n && items(i).live;
  if (mine) {
    const Item it = items(i);
    if (dbl)
      dbl_single1(k, it.a, t);
    else
      add_single1(k, it.a, it.b, it.neg, t);
  }
  g.sync();
  if (mine) {
    if (dbl)
      dbl_single2(k, t, t + 6 * SLOT);
    else
      add_single2(k, t, t + 6 * SLOT);
  }
  g.sync();
  if (u < 3 * n) {
    const int ic = u / 3;
    const Item it = items(ic);
    if (it.live) combine(u % 3, dbl, scratch + SINGLE_SCRATCH * ic + 6 * SLOT, it.dst);
  }
  g.sync();
}

// n additions items(i) (i < n); ends with a barrier. A few items take one
// product a lane; more take two a lane, in batches of GROUP_NB.
template <class Items>
DEV void group_add(const Group& g, uint32_t* scratch, int n, Items items) {
  if (6 * n <= g.G) {
    group_single(g, scratch, n, false, items);
    return;
  }
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += GROUP_NB) {
    const int m = min(GROUP_NB, n - i0);
#pragma unroll 1
    for (int u = g.lane; u < 3 * m; u += g.G) {
      const Item it = items(i0 + u / 3);
      if (it.live) add_stage1(u % 3, it.a, it.b, it.neg, scratch + ADD_SCRATCH * (u / 3));
    }
    g.sync();
#pragma unroll 1
    for (int u = g.lane; u < 3 * m; u += g.G) {
      const Item it = items(i0 + u / 3);
      if (it.live) add_stage2(u % 3, scratch + ADD_SCRATCH * (u / 3), it.dst);
    }
    g.sync();
  }
}

// n doublings items(i).dst = 2 items(i).a; ends with a barrier (as group_add)
template <class Items>
DEV void group_double(const Group& g, uint32_t* scratch, int n, Items items) {
  if (4 * n <= g.G) {
    group_single(g, scratch, n, true, items);
    return;
  }
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += GROUP_NB) {
    const int m = min(GROUP_NB, n - i0);
#pragma unroll 1
    for (int u = g.lane; u < 2 * m; u += g.G) {
      const Item it = items(i0 + u / 2);
      if (it.live) dbl_stage1(u % 2, it.a, scratch + ADD_SCRATCH * (u / 2));
    }
    g.sync();
#pragma unroll 1
    for (int u = g.lane; u < 2 * m; u += g.G) {
      const Item it = items(i0 + u / 2);
      if (it.live) dbl_stage2(u % 2, scratch + ADD_SCRATCH * (u / 2), it.dst);
    }
    g.sync();
  }
}

// Tables of multiples of c points: tab holds, per point, entries 1..half
// (half a power of two; entry 1, the point, already written). Entry e is
// entry ceil(e/2) plus entry floor(e/2), in log2(half) levels of
// independent additions. Ends with a barrier.
DEV void group_tables(const Group& g, uint32_t* scratch, uint32_t* tab, int c, int half) {
  auto T = [&](int k, int e) { return tab + PT * (k * half + e - 1); };
#pragma unroll 1
  for (int nl = 1; nl < half; nl *= 2) {  // entries nl + 1 .. 2 nl
    group_add(g, scratch, c * nl, [&](int i) {
      const int k = i / nl, e = nl + 1 + i % nl;
      return Item{T(k, e), T(k, (e + 1) / 2), T(k, e / 2), false, true};
    });
  }
}

// Window sums: for each of c points k in turn, wsum[j] += d T(k, |d|) for
// every job j < J with the signed digit d = dig[k J + j] (nothing for
// d = 0). Ends with a barrier.
DEV void group_window_terms(const Group& g, uint32_t* scratch, uint32_t* wsum, int J, const uint32_t* tab,
                            int half, const int8_t* dig, int c) {
#pragma unroll 1
  for (int k = 0; k < c; k++) {
    group_add(g, scratch, J, [&](int j) {
      const int d = dig[k * J + j];
      const int m = d < 0 ? -d : d;
      return Item{wsum + PT * j, wsum + PT * j, tab + PT * (k * half + (m > 0 ? m - 1 : 0)), d < 0, d != 0};
    });
  }
}

// The doubling chain over window sums, for R independent sums at once:
// acc[r] = sum_w 2^(wbits w) wsum[r nwin + w], MSB window first (acc starts
// at the top window's sum). Ends with a barrier.
DEV void group_window_chain(const Group& g, uint32_t* scratch, uint32_t* acc, const uint32_t* wsum, int R,
                            int nwin, int wbits) {
#pragma unroll 1
  for (int r = 0; r < R; r++) group_copy(g, acc + PT * r, wsum + PT * (r * nwin + nwin - 1), 1);
  g.sync();
#pragma unroll 1
  for (int w = nwin - 2; w >= 0; w--) {
#pragma unroll 1
    for (int s = 0; s < wbits; s++)
      group_double(g, scratch, R, [&](int r) { return Item{acc + PT * r, acc + PT * r, nullptr, false, true}; });
    group_add(g, scratch, R, [&](int r) {
      return Item{acc + PT * r, acc + PT * r, wsum + PT * (r * nwin + w), false, true};
    });
  }
}

// ---- the aggregate subgroup test --------------------------------------------
// The port of ops/curve.aggregate_subgroup_check: per row and round,
// Q = sum_k w_k P_k with verifier-chosen weights w_k in [1, 2^16) (signed
// 3-bit windows over the 5-entry tables [0P..4P], one chain of 3
// doublings a window), then Q in G1 <=> phi(Q) == [z^2 - 1] Q with
// phi(x, y) = (beta x, y) (Bowe 2019), the identity counting as a member.
// The verdict depends only on the points and the weights: Q is the same
// point whichever way it is summed, and the test is projective-invariant.

constexpr int AGG_WBITS = 3, AGG_NWIN = 6, AGG_HALF = 4;

// Row layout (words) of the aggregate test for K points and R rounds: the
// tables (K x AGG_HALF points; entry 1 of point k, at PT * k * AGG_HALF,
// is the decoded point), the window sums (R x AGG_NWIN), Q, the ladder's
// base and accumulator (R points each), the scratch, R verdict words, and
// the digits (K x R x AGG_NWIN bytes).
struct AggLayout {
  int tab, wsum, q, base, t, scratch, ok, dig, words;
  __host__ __device__ AggLayout(int K, int R) {
    tab = 0;
    wsum = tab + PT * K * AGG_HALF;
    q = wsum + PT * R * AGG_NWIN;
    base = q + PT * R;
    t = base + PT * R;
    scratch = t + PT * R;
    ok = scratch + ADD_SCRATCH * GROUP_NB;
    dig = ok + 4;
    words = dig + ((K * R * AGG_NWIN + 15) / 16) * 4;
  }
};

// t[r] = [|z|] base[r] for R points: 63 doublings, and an addition at each
// one-bit of |z| below the top one. Ends with a barrier.
DEV void group_mul_z_abs(const Group& g, uint32_t* scratch, uint32_t* t, const uint32_t* base, int R) {
  group_copy(g, t, base, R);
  g.sync();
#pragma unroll 1
  for (int i = 62; i >= 0; i--) {
    group_double(g, scratch, R, [&](int r) { return Item{t + PT * r, t + PT * r, nullptr, false, true}; });
    if ((BLS_X_ABS >> i) & 1)
      group_add(g, scratch, R, [&](int r) { return Item{t + PT * r, t + PT * r, base + PT * r, false, true}; });
  }
}

// The row's aggregate subgroup verdict over `rounds` rounds, on the K points
// already at entry 1 of the row's tables (layout AggLayout(K, rounds) at
// row); weights (rounds, K) in [1, 2^16). Every lane of the group calls it;
// every lane gets the verdict. ph, if given, receives clock64() after the
// window chain.
DEV bool group_aggregate_ok(const Group& g, uint32_t* row, int K, const int* weights, int rounds,
                            long long* ph = nullptr) {
  const int R = rounds, J = R * AGG_NWIN;
  const AggLayout L(K, R);
  uint32_t *tab = row + L.tab, *wsum = row + L.wsum, *q = row + L.q, *base = row + L.base, *t = row + L.t;
  uint32_t* scratch = row + L.scratch;
  int8_t* dig = reinterpret_cast<int8_t*>(row + L.dig);
  // signed 3-bit digits of each weight: d in [-4, 4], the top window never carries
#pragma unroll 1
  for (int u = g.lane; u < R * K; u += g.G) {
    const int r = u / K, k = u % K;
    const uint32_t w = (uint32_t)LDG(weights + r * K + k);
    int carry = 0;
#pragma unroll
    for (int i = 0; i < AGG_NWIN; i++) {
      const int d = (int)((w >> (AGG_WBITS * i)) & 7) + carry;
      carry = d > AGG_HALF;
      dig[k * J + r * AGG_NWIN + i] = (int8_t)(carry ? d - 2 * AGG_HALF : d);
    }
  }
  group_identity(g, wsum, J);
  g.sync();
  group_tables(g, scratch, tab, K, AGG_HALF);
  group_window_terms(g, scratch, wsum, J, tab, AGG_HALF, dig, K);
  group_window_chain(g, scratch, q, wsum, R, AGG_NWIN, AGG_WBITS);
  if (ph) *ph = clock64();
  // [z^2] Q by two ladders, then [z^2 - 1] Q
  group_mul_z_abs(g, scratch, t, q, R);
  group_copy(g, base, t, R);
  g.sync();
  group_mul_z_abs(g, scratch, t, base, R);
  group_add(g, scratch, R, [&](int r) { return Item{t + PT * r, t + PT * r, q + PT * r, true, true}; });
  // phi(Q) == T by cross products: (beta Qx) Tz == Tx Qz and Qy Tz == Ty Qz
  uint32_t* okw = row + L.ok;
#pragma unroll 1
  for (int u = g.lane; u < 2 * R; u += g.G) {
    const int r = u / 2, k = u % 2;
    const uint32_t *Q = q + PT * r, *T = t + PT * r;
    uint32_t a0[SLOT], b0[SLOT], a1[SLOT], b1[SLOT];
    s_load(a0, Q + SLOT * (k == 0 ? 0 : 1));  // Qx | Qy
    if (k == 0) {
      f_copy<FpT>(b0, FP_BETA);
    } else {
      s_load(b0, T + 2 * SLOT);  // Tz
    }
    s_load(a1, T + SLOT * k);  // Tx | Ty
    s_load(b1, Q + 2 * SLOT);  // Qz
    f_mul2<FpT>(a0, a0, b0, a1, a1, b1);
    s_store(scratch + ADD_SCRATCH * r + SLOT * (2 * k), a0);
    s_store(scratch + ADD_SCRATCH * r + SLOT * (2 * k + 1), a1);
  }
  g.sync();
#pragma unroll 1
  for (int r = g.lane; r < R; r += g.G) {
    const uint32_t *Q = q + PT * r, *T = t + PT * r, *s = scratch + ADD_SCRATCH * r;
    uint32_t a[SLOT], b[SLOT];
    s_load(a, s);  // beta Qx
    s_load(b, T + 2 * SLOT);
    f_mul<FpT>(a, a, b);
    bool ok;
    if (f_is_zero<FpT>(Q + 2 * SLOT)) {
      ok = true;  // the identity is a member
    } else if (f_is_zero<FpT>(T + 2 * SLOT)) {
      ok = false;
    } else {
      s_load(b, s + SLOT);
      ok = f_eq<FpT>(a, b);
      s_load(a, s + 2 * SLOT);
      s_load(b, s + 3 * SLOT);
      ok = ok && f_eq<FpT>(a, b);
    }
    okw[r] = ok;
  }
  g.sync();
  bool ok = true;
#pragma unroll 1
  for (int r = 0; r < R; r++) ok = ok && okw[r] != 0;
  g.sync();  // the caller may reuse the row
  return ok;
}

// The body of a kernel that gives each of B rows of K points a group of
// `lanes` lanes and the row's AggLayout(K, rounds) in shared memory: one
// lane a point makes point i = row K + k by load(P, i) into entry 1 of its
// table, then the group runs group_aggregate_ok and lane 0 writes the
// verdict to ok_out[row]. phases (optional, (B, 4)): clock64() at the
// start, after the loads, after the window chain, at the end.
template <class Load>
DEV void aggregate_rows(Load load, const int* weights, uint8_t* ok_out, long long* phases, int B, int K,
                        int rounds, int lanes) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Group g = make_group(lanes);
  const int slot = threadIdx.x / lanes;
  const int row = blockIdx.x * (blockDim.x / lanes) + slot;
  if (row >= B) return;  // the whole group leaves; only group barriers follow
  uint32_t* tab = smem + (size_t)slot * AggLayout(K, rounds).words;
  long long* ph = (phases != nullptr && g.lane == 0) ? phases + (size_t)row * 4 : nullptr;
  if (ph) ph[0] = clock64();
#pragma unroll 1
  for (int k = g.lane; k < K; k += g.G) {
    Pt P;
    load(P, (size_t)row * K + k);
    uint32_t* e1 = tab + PT * k * AGG_HALF;
    s_store(e1, P.x);
    s_store(e1 + SLOT, P.y);
    s_store(e1 + 2 * SLOT, P.z);
  }
  g.sync();
  if (ph) ph[1] = clock64();
  const bool ok = group_aggregate_ok(g, tab, K, weights, rounds, ph ? ph + 2 : nullptr);
  if (ph) ph[3] = clock64();
  if (g.lane == 0) ok_out[row] = ok;
}

// Launches `kernel`, a kernel over aggregate_rows, on B rows of K points
// and `rounds` rounds: `lanes` a row, rows a block from group_rows.
// cudaErrorInvalidValue where the arguments are out of range or not one
// row fits a block.
template <class Kernel, class... Args>
static inline int launch_aggregate_rows(Kernel* kernel, int B, int K, int rounds, int lanes, cudaStream_t st,
                                        Args... args) {
  if (rounds < 1 || rounds > 4) return (int)cudaErrorInvalidValue;
  const size_t row_bytes = sizeof(uint32_t) * AggLayout(K, rounds).words;
  const int rows = group_rows(B, lanes, row_bytes);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = rows * row_bytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + rows - 1) / rows, rows * lanes, smem, st>>>(args...);
  return (int)cudaGetLastError();
}
