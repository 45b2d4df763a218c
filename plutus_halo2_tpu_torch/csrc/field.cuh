// Device field library for the Hopper kernels: the counterpart of
// plutus_halo2_tpu/ops/pallas_core.py:109 (KField) and :385-444
// (window_digits, pow_win_loop_tab).
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

// a^e, e given MSB-first as 4-bit window digits: the power table
// [1, a, ..., a^15] lives in local memory; 4 squarings and one table
// multiply per digit (the port of pow_win_loop_tab).
template <class F, class Digit>
DEV void pow_window(uint32_t* acc, const uint32_t* a, Digit digit, int nd) {
  uint32_t tab[16][F::NW];
  f_one<F>(tab[0]);
  f_copy<F>(tab[1], a);
#pragma unroll 1
  for (int k = 2; k < 16; k++) f_mul<F>(tab[k], tab[k - 1], a);
  f_copy<F>(acc, tab[digit(0)]);
#pragma unroll 1
  for (int w = 1; w < nd; w++) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) f_mul<F>(acc, acc, acc);
    f_mul<F>(acc, acc, tab[digit(w)]);
  }
}

// Digit getter over a constant exponent held as NW words (MSB-first).
template <int NWE>
struct WordDigits {
  const uint32_t* e;
  DEV int operator()(int w) const {
    const int bit = 4 * (8 * NWE - 1 - w);  // low bit of digit w
    return (e[bit >> 5] >> (bit & 31)) & 0xf;
  }
};
