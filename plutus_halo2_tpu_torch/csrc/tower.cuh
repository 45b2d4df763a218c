// Fp2 / Fp6 / Fp12 tower over the device field library: the counterpart of
// plutus_halo2_tpu/ops/pallas_pairing.py:69-409 (k2_*, k6_*, k12_*) and of
// ops/tower.py in this package.
//
// Fp2  = Fp[u]/(u^2 + 1); Fp12 = Fp2[w]/(w^6 - xi), xi = u + 1, held as the
// six Fp2 coefficients of w^0..w^5; Fp6 = Fp2[v]/(v^3 - xi), v = w^2.
// Products are schoolbook over Fp2 (Karatsuba inside Fp2: 3 Fp products),
// so an Fp12 product is 108 Fp products. The Fp12 functions are
// __noinline__ with rolled loops to keep nvcc's compile time short.
#pragma once
#include "field.cuh"

struct Fp {
  uint32_t w[12];
};
struct Fp2 {
  Fp a, b;  // a + b u
};
struct Fp6 {
  Fp2 c[3];
};
struct Fp12 {
  Fp2 c[6];
};

DEV void fp_add(Fp& r, const Fp& x, const Fp& y) { f_add<FpT>(r.w, x.w, y.w); }
DEV void fp_sub(Fp& r, const Fp& x, const Fp& y) { f_sub<FpT>(r.w, x.w, y.w); }
DEV void fp_neg(Fp& r, const Fp& x) { f_neg<FpT>(r.w, x.w); }
DEV void fp_mul(Fp& r, const Fp& x, const Fp& y) { f_mul<FpT>(r.w, x.w, y.w); }
DEV void fp_zero(Fp& r) { f_zero<FpT>(r.w); }
DEV void fp_one(Fp& r) { f_one<FpT>(r.w); }
DEV bool fp_is_zero(const Fp& x) { return f_is_zero<FpT>(x.w); }

// x^(p-2): the Fermat inverse (0 maps to 0)
DEV_NOINLINE void fp_inv(Fp& r, const Fp& x) {
  pow_window<FpT>(r.w, x.w, WordDigits<12>{FP_PM2}, 96);
}

DEV void fp2_add(Fp2& r, const Fp2& x, const Fp2& y) {
  fp_add(r.a, x.a, y.a);
  fp_add(r.b, x.b, y.b);
}
DEV void fp2_sub(Fp2& r, const Fp2& x, const Fp2& y) {
  fp_sub(r.a, x.a, y.a);
  fp_sub(r.b, x.b, y.b);
}
DEV void fp2_neg(Fp2& r, const Fp2& x) {
  fp_neg(r.a, x.a);
  fp_neg(r.b, x.b);
}
DEV void fp2_conj(Fp2& r, const Fp2& x) {
  r.a = x.a;
  fp_neg(r.b, x.b);
}
DEV void fp2_zero(Fp2& r) {
  fp_zero(r.a);
  fp_zero(r.b);
}
DEV void fp2_one(Fp2& r) {
  fp_one(r.a);
  fp_zero(r.b);
}

// Karatsuba: 3 Fp products; r may alias x or y
DEV_NOINLINE void fp2_mul(Fp2& r, const Fp2& x, const Fp2& y) {
  Fp m0, m1, m2, s0, s1;
  fp_mul(m0, x.a, y.a);
  fp_mul(m1, x.b, y.b);
  fp_add(s0, x.a, x.b);
  fp_add(s1, y.a, y.b);
  fp_mul(m2, s0, s1);
  fp_sub(r.a, m0, m1);
  fp_add(s0, m0, m1);
  fp_sub(r.b, m2, s0);
}

DEV void fp2_mul_fp(Fp2& r, const Fp2& x, const Fp& s) {
  fp_mul(r.a, x.a, s);
  fp_mul(r.b, x.b, s);
}

// xi * x = (x.a - x.b) + (x.a + x.b) u
DEV void fp2_xi(Fp2& r, const Fp2& x) {
  Fp t;
  fp_sub(t, x.a, x.b);
  fp_add(r.b, x.a, x.b);
  r.a = t;
}

DEV_NOINLINE void fp2_inv(Fp2& r, const Fp2& x) {
  Fp n, t, ni;
  fp_mul(n, x.a, x.a);
  fp_mul(t, x.b, x.b);
  fp_add(n, n, t);
  fp_inv(ni, n);
  fp_mul(r.a, x.a, ni);
  fp_mul(t, x.b, ni);
  fp_neg(r.b, t);
}

// --- Fp6 over v, v^3 = xi --------------------------------------------------

DEV_NOINLINE void fp6_mul(Fp6& r, const Fp6& x, const Fp6& y) {
  Fp6 acc;
#pragma unroll 1
  for (int k = 0; k < 3; k++) fp2_zero(acc.c[k]);
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
#pragma unroll 1
    for (int j = 0; j < 3; j++) {
      Fp2 p;
      fp2_mul(p, x.c[i], y.c[j]);
      int k = i + j;
      if (k >= 3) {
        fp2_xi(p, p);
        k -= 3;
      }
      fp2_add(acc.c[k], acc.c[k], p);
    }
  }
  r = acc;
}

DEV void fp6_sub(Fp6& r, const Fp6& x, const Fp6& y) {
  for (int k = 0; k < 3; k++) fp2_sub(r.c[k], x.c[k], y.c[k]);
}

// (a0, a1, a2) -> (xi a2, a0, a1)
DEV void fp6_mul_by_v(Fp6& r, const Fp6& x) {
  Fp2 t;
  fp2_xi(t, x.c[2]);
  r.c[2] = x.c[1];
  r.c[1] = x.c[0];
  r.c[0] = t;
}

DEV_NOINLINE void fp6_inv(Fp6& r, const Fp6& x) {
  Fp2 t0, t1, c0, c1, c2, t;
  fp2_mul(t0, x.c[0], x.c[0]);
  fp2_mul(t1, x.c[1], x.c[2]);
  fp2_xi(t1, t1);
  fp2_sub(c0, t0, t1);  // a0^2 - xi a1 a2
  fp2_mul(t0, x.c[2], x.c[2]);
  fp2_xi(t0, t0);
  fp2_mul(t1, x.c[0], x.c[1]);
  fp2_sub(c1, t0, t1);  // xi a2^2 - a0 a1
  fp2_mul(t0, x.c[1], x.c[1]);
  fp2_mul(t1, x.c[0], x.c[2]);
  fp2_sub(c2, t0, t1);  // a1^2 - a0 a2
  fp2_mul(t0, x.c[2], c1);
  fp2_mul(t1, x.c[1], c2);
  fp2_add(t0, t0, t1);
  fp2_xi(t0, t0);
  fp2_mul(t1, x.c[0], c0);
  fp2_add(t, t1, t0);  // a0 c0 + xi (a2 c1 + a1 c2)
  fp2_inv(t, t);
  fp2_mul(r.c[0], c0, t);
  fp2_mul(r.c[1], c1, t);
  fp2_mul(r.c[2], c2, t);
}

// --- Fp12 over w, w^6 = xi --------------------------------------------------

DEV void fp12_one(Fp12& r) {
  fp2_one(r.c[0]);
  for (int k = 1; k < 6; k++) fp2_zero(r.c[k]);
}

DEV_NOINLINE void fp12_mul(Fp12& r, const Fp12& x, const Fp12& y) {
  Fp12 acc;
#pragma unroll 1
  for (int k = 0; k < 6; k++) fp2_zero(acc.c[k]);
#pragma unroll 1
  for (int i = 0; i < 6; i++) {
#pragma unroll 1
    for (int j = 0; j < 6; j++) {
      Fp2 p;
      fp2_mul(p, x.c[i], y.c[j]);
      int k = i + j;
      if (k >= 6) {
        fp2_xi(p, p);
        k -= 6;
      }
      fp2_add(acc.c[k], acc.c[k], p);
    }
  }
  r = acc;
}

DEV void fp12_sqr(Fp12& r, const Fp12& x) { fp12_mul(r, x, x); }

// f *= c0 + c2 w^2 + c3 w^3 (the sparse Miller-loop line): 18 Fp2 products
DEV_NOINLINE void fp12_mul_sparse023(Fp12& f, const Fp2& c0, const Fp2& c2, const Fp2& c3) {
  Fp12 acc;
#pragma unroll 1
  for (int k = 0; k < 6; k++) fp2_zero(acc.c[k]);
#pragma unroll 1
  for (int i = 0; i < 6; i++) {
#pragma unroll 1
    for (int s = 0; s < 3; s++) {
      const Fp2& c = s == 0 ? c0 : (s == 1 ? c2 : c3);
      const int slot = s == 0 ? 0 : s + 1;
      Fp2 p;
      fp2_mul(p, f.c[i], c);
      int k = i + slot;
      if (k >= 6) {
        fp2_xi(p, p);
        k -= 6;
      }
      fp2_add(acc.c[k], acc.c[k], p);
    }
  }
  f = acc;
}

// f^(p^6): negate the odd w-power coefficients
DEV void fp12_conj(Fp12& r, const Fp12& x) {
  for (int k = 0; k < 6; k++) {
    if (k & 1)
      fp2_neg(r.c[k], x.c[k]);
    else
      r.c[k] = x.c[k];
  }
}

// f^(p^k), k in {1, 2, 3}: conjugate each coefficient (odd k) and scale
// coefficient i by gamma_k^i (FP_GAMMA, generated from refimpl/curve.py)
DEV_NOINLINE void fp12_frobenius(Fp12& r, const Fp12& x, int k) {
#pragma unroll 1
  for (int i = 0; i < 6; i++) {
    Fp2 c, g;
    if (k & 1)
      fp2_conj(c, x.c[i]);
    else
      c = x.c[i];
    const uint32_t* src = FP_GAMMA + ((k - 1) * 6 + i) * 24;
    for (int w = 0; w < 12; w++) {
      g.a.w[w] = src[w];
      g.b.w[w] = src[12 + w];
    }
    fp2_mul(r.c[i], c, g);
  }
}

// f = A + B w with A, B in Fp6: f^-1 = (A - B w) / (A^2 - B^2 v)
DEV_NOINLINE void fp12_inv(Fp12& r, const Fp12& x) {
  Fp6 A, B, A2, B2, D;
  for (int k = 0; k < 3; k++) {
    A.c[k] = x.c[2 * k];
    B.c[k] = x.c[2 * k + 1];
  }
  fp6_mul(A2, A, A);
  fp6_mul(B2, B, B);
  fp6_mul_by_v(B2, B2);
  fp6_sub(D, A2, B2);
  fp6_inv(D, D);
  fp6_mul(A, A, D);
  fp6_mul(B, B, D);
  for (int k = 0; k < 3; k++) {
    r.c[2 * k] = A.c[k];
    fp2_neg(r.c[2 * k + 1], B.c[k]);
  }
}

DEV bool fp12_is_one(const Fp12& x) {
  Fp2 one;
  fp2_one(one);
  bool ok = f_eq<FpT>(x.c[0].a.w, one.a.w) && f_is_zero<FpT>(x.c[0].b.w);
  for (int k = 1; k < 6; k++) ok = ok && fp_is_zero(x.c[k].a) && fp_is_zero(x.c[k].b);
  return ok;
}
