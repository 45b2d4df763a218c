// Device field library for the Hopper kernels: the counterpart of
// plutus_halo2_tpu/ops/pallas_core.py:109 (KField); the window ladder of
// :385-444 (pow_win_loop_tab) is pow.cu's, over lanes.cuh's product.
//
// Representation. An element is NW 32-bit words, little-endian, in the
// Montgomery domain with R = 2^(32 NW): Fp has NW = 12 (R = 2^384), Fr has
// NW = 8 (R = 2^256). Every op returns a fully reduced value (< N); there is
// no lazy [0, 2N) domain, so no margin argument is needed.
//
// Bound. Everything built on this file is bounded by the 32x32 -> 64-bit
// integer multiply: a CIOS Montgomery product costs 2 NW^2 + NW word
// products (300 for Fp, 136 for Fr), and adds/subs are a few percent of that.
//
// Boundary. The Python side (ops/limb.py) holds 16-bit limbs in int64 with
// R = 2^(16 L) (L = 25 for Fp, 17 for Fr). A kernel packs limb pairs into
// words and multiplies once by F::to_k (Fp: 2^368 mod p) on the way in, and
// once by F::from_k (Fp: 2^400 mod p) on the way out; both values are exact
// Montgomery products, so kernel results equal the plain versions' limbs.
#pragma once
#include <cstdint>

#define DEV __device__ __forceinline__
#define DEV_NOINLINE __device__ __noinline__
#define LDG(p) __ldg(p)

#include "field_consts.cuh"  // generated: FP_*/FR_* moduli and boundary factors

struct FpT {
  static constexpr int NW = 12, L16 = 25;
  DEV static uint32_t mod(int i) { return FP_MOD[i]; }
  DEV static uint32_t n0() { return FP_N0; }
  DEV static uint32_t one(int i) { return FP_ONE[i]; }
  DEV static uint32_t to_k(int i) { return FP_TO_K[i]; }
  DEV static uint32_t from_k(int i) { return FP_FROM_K[i]; }
};

struct FrT {
  static constexpr int NW = 8, L16 = 17;
  DEV static uint32_t mod(int i) { return FR_MOD[i]; }
  DEV static uint32_t n0() { return FR_N0; }
  DEV static uint32_t one(int i) { return FR_ONE[i]; }
  DEV static uint32_t to_k(int i) { return FR_TO_K[i]; }
  DEV static uint32_t from_k(int i) { return FR_FROM_K[i]; }
};

template <class F>
DEV void f_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < F::NW; i++) r[i] = a[i];
}

template <class F>
DEV void f_zero(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < F::NW; i++) r[i] = 0;
}

template <class F>
DEV void f_one(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < F::NW; i++) r[i] = F::one(i);
}

template <class F>
DEV bool f_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < F::NW; i++) acc |= a[i];
  return acc == 0;
}

template <class F>
DEV bool f_eq(const uint32_t* a, const uint32_t* b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < F::NW; i++) acc |= a[i] ^ b[i];
  return acc == 0;
}

// r = t - N if t >= N else t, for t < 2N held in NW words (2N < R for both
// fields, so no carry word is needed).
template <class F>
DEV void f_reduce_once(uint32_t* r, const uint32_t* t) {
  uint32_t s[F::NW];
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < F::NW; i++) {
    uint64_t d = (uint64_t)t[i] - F::mod(i) - br;
    s[i] = (uint32_t)d;
    br = d >> 63;
  }
  // br == 1: t < N, keep t
#pragma unroll
  for (int i = 0; i < F::NW; i++) r[i] = br ? t[i] : s[i];
}

template <class F>
DEV void f_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[F::NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < F::NW; i++) {
    c += (uint64_t)a[i] + b[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  f_reduce_once<F>(r, t);
}

template <class F>
DEV void f_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[F::NW];
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < F::NW; i++) {
    uint64_t d = (uint64_t)a[i] - b[i] - br;
    t[i] = (uint32_t)d;
    br = d >> 63;
  }
  const uint32_t m = br ? 0xffffffffu : 0u;  // a < b: add N back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < F::NW; i++) {
    c += (uint64_t)t[i] + (F::mod(i) & m);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

template <class F>
DEV void f_neg(uint32_t* r, const uint32_t* a) {
  uint32_t z[F::NW];
  f_zero<F>(z);
  f_sub<F>(r, z, a);
}

// CIOS Montgomery product r = a b / R mod N for a, b < N (r may alias a or b).
template <class F>
DEV void f_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int NW = F::NW;
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + C;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::n0();
    s = (uint64_t)m * F::mod(0) + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      s = (uint64_t)m * F::mod(j) + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[NW] + C;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  f_reduce_once<F>(r, t);  // t < 2N, t[NW] == 0
}

// Two independent CIOS Montgomery products in one instruction stream (the
// pairing kernel's product stages; the lane-group kernels' stages over
// many items). On an H100 a step of the two takes 2.3x the cycles of one
// product with one warp an SM, 2.0x with eight (tools/curve_probe.py).
template <class F>
DEV void f_mul2(uint32_t* r0, const uint32_t* a0, const uint32_t* b0, uint32_t* r1, const uint32_t* a1,
                const uint32_t* b1) {
  constexpr int NW = F::NW;
  uint32_t t0[NW + 2], t1[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; i++) t0[i] = t1[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t C0 = 0, C1 = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      const uint64_t s0 = (uint64_t)a0[i] * b0[j] + t0[j] + C0;
      const uint64_t s1 = (uint64_t)a1[i] * b1[j] + t1[j] + C1;
      t0[j] = (uint32_t)s0;
      t1[j] = (uint32_t)s1;
      C0 = s0 >> 32;
      C1 = s1 >> 32;
    }
    uint64_t s0 = (uint64_t)t0[NW] + C0, s1 = (uint64_t)t1[NW] + C1;
    t0[NW] = (uint32_t)s0;
    t1[NW] = (uint32_t)s1;
    t0[NW + 1] = (uint32_t)(s0 >> 32);
    t1[NW + 1] = (uint32_t)(s1 >> 32);
    const uint32_t m0 = t0[0] * F::n0(), m1 = t1[0] * F::n0();
    s0 = (uint64_t)m0 * F::mod(0) + t0[0];
    s1 = (uint64_t)m1 * F::mod(0) + t1[0];
    C0 = s0 >> 32;
    C1 = s1 >> 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      s0 = (uint64_t)m0 * F::mod(j) + t0[j] + C0;
      s1 = (uint64_t)m1 * F::mod(j) + t1[j] + C1;
      t0[j - 1] = (uint32_t)s0;
      t1[j - 1] = (uint32_t)s1;
      C0 = s0 >> 32;
      C1 = s1 >> 32;
    }
    s0 = (uint64_t)t0[NW] + C0;
    s1 = (uint64_t)t1[NW] + C1;
    t0[NW - 1] = (uint32_t)s0;
    t1[NW - 1] = (uint32_t)s1;
    t0[NW] = t0[NW + 1] + (uint32_t)(s0 >> 32);
    t1[NW] = t1[NW + 1] + (uint32_t)(s1 >> 32);
  }
  f_reduce_once<F>(r0, t0);
  f_reduce_once<F>(r1, t1);
}

// ---- PTX carry-chain Fp product --------------------------------------------
// t[0..12] += a * b (12-word b): the low halves of a b_j added at word j and
// the high halves at word j + 1, each as one carry chain (mad / madc on the
// PTX carry flag, one instruction a word). t stays below 2^415 (CIOS with
// p < 2^381), so nothing carries out of t[12].
DEV void fp_mac_row(uint32_t* t, uint32_t a, const uint32_t* b) {
  asm("mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
      "madc.lo.cc.u32 %1, %13, %15, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %16, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %13, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %13, %20, %6;\n\t"
      "madc.lo.cc.u32 %7, %13, %21, %7;\n\t"
      "madc.lo.cc.u32 %8, %13, %22, %8;\n\t"
      "madc.lo.cc.u32 %9, %13, %23, %9;\n\t"
      "madc.lo.cc.u32 %10, %13, %24, %10;\n\t"
      "madc.lo.cc.u32 %11, %13, %25, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  asm("mad.hi.cc.u32 %0, %12, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %14, %1;\n\t"
      "madc.hi.cc.u32 %2, %12, %15, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %12, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %20, %7;\n\t"
      "madc.hi.cc.u32 %8, %12, %21, %8;\n\t"
      "madc.hi.cc.u32 %9, %12, %22, %9;\n\t"
      "madc.hi.cc.u32 %10, %12, %23, %10;\n\t"
      "madc.hi.u32 %11, %12, %24, %11;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
}

// CIOS Montgomery product r = a b / R mod p for a, b < p (r may alias a or
// b), by PTX carry chains: the same value as f_mul<FpT>, but no faster on
// an H100 (tools/curve_probe.py), so the kernels keep f_mul and only the
// probe runs this one.
DEV void fp_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[13], p[12];
#pragma unroll
  for (int i = 0; i < 13; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) p[i] = FpT::mod(i);
#pragma unroll
  for (int i = 0; i < 12; i++) {
    fp_mac_row(t, a[i], b);
    fp_mac_row(t, t[0] * FpT::n0(), p);  // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < 12; j++) t[j] = t[j + 1];
    t[12] = 0;
  }
  f_reduce_once<FpT>(r, t);  // t < 2p
}

// r = a + b mod p for a, b < p, by PTX carry chains (the same value as
// f_add<FpT>): the sum (below 2^382), then p subtracted unless that borrows.
DEV void fp_add_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[12], d[12], bw;
#pragma unroll
  for (int i = 0; i < 12; i++) t[i] = a[i];
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]),
        "r"(b[9]), "r"(b[10]), "r"(b[11]));
#pragma unroll
  for (int i = 0; i < 12; i++) d[i] = t[i];
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "=r"(bw)
      : "r"(FpT::mod(0)), "r"(FpT::mod(1)), "r"(FpT::mod(2)), "r"(FpT::mod(3)), "r"(FpT::mod(4)),
        "r"(FpT::mod(5)), "r"(FpT::mod(6)), "r"(FpT::mod(7)), "r"(FpT::mod(8)), "r"(FpT::mod(9)),
        "r"(FpT::mod(10)), "r"(FpT::mod(11)));
#pragma unroll
  for (int i = 0; i < 12; i++) r[i] = bw ? t[i] : d[i];  // bw: all ones when t < p
}

// r = a - b mod p for a, b < p, by PTX carry chains (the same value as
// f_sub<FpT>): the difference, then p added back where it borrowed.
DEV void fp_sub_cc(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[12], bw;
#pragma unroll
  for (int i = 0; i < 12; i++) t[i] = a[i];
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(bw)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]),
        "r"(b[9]), "r"(b[10]), "r"(b[11]));
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
      : "r"(FpT::mod(0) & bw), "r"(FpT::mod(1) & bw), "r"(FpT::mod(2) & bw), "r"(FpT::mod(3) & bw),
        "r"(FpT::mod(4) & bw), "r"(FpT::mod(5) & bw), "r"(FpT::mod(6) & bw), "r"(FpT::mod(7) & bw),
        "r"(FpT::mod(8) & bw), "r"(FpT::mod(9) & bw), "r"(FpT::mod(10) & bw), "r"(FpT::mod(11) & bw));
#pragma unroll
  for (int i = 0; i < 12; i++) r[i] = t[i];
}

// Port limbs (int64 16-bit, R = 2^(16 L16)) -> kernel words (R = 2^(32 NW)).
template <class F>
DEV void load_port(uint32_t* r, const int64_t* limbs) {
  uint32_t w[F::NW], c[F::NW];
#pragma unroll
  for (int i = 0; i < F::NW; i++) {
    w[i] = (uint32_t)limbs[2 * i] | ((uint32_t)limbs[2 * i + 1] << 16);
    c[i] = F::to_k(i);
  }
  f_mul<F>(r, w, c);
}

// Kernel words -> port limbs; the limbs past 2 NW are zero.
template <class F>
DEV void store_port(int64_t* limbs, const uint32_t* a) {
  uint32_t w[F::NW], c[F::NW];
#pragma unroll
  for (int i = 0; i < F::NW; i++) c[i] = F::from_k(i);
  f_mul<F>(w, a, c);
#pragma unroll
  for (int i = 0; i < F::NW; i++) {
    limbs[2 * i] = w[i] & 0xffffu;
    limbs[2 * i + 1] = w[i] >> 16;
  }
  for (int i = 2 * F::NW; i < F::L16; i++) limbs[i] = 0;
}

// Canonical (non-Montgomery) port limbs -> plain words (scalars).
template <int NW>
DEV void load_words(uint32_t* r, const int64_t* limbs) {
#pragma unroll
  for (int i = 0; i < NW; i++)
    r[i] = (uint32_t)limbs[2 * i] | ((uint32_t)limbs[2 * i + 1] << 16);
}
