// Fr polynomial runtime of the prover: the port of the JAX package's host
// runtime plutus_halo2_tpu/native/ph2_native.cpp (host C++ through ctypes,
// no Pallas kernel): fr_ntt (:138-172), fr_mul_array (:174-181),
// fr_scale_array (:183-189) and fr_powers_mul_array (:191-201), which
// refimpl/poly.py gives every array of 128 or more elements.
//
// Values. An array is (n, 8) little-endian 32-bit words of canonical values
// (< q), as fr_from_bytes / fr_to_bytes read and write them. The data never
// enters the Montgomery domain: f_mul of a canonical a and a constant in the
// Montgomery domain (c R mod q, R = 2^256) is a c R / R = a c, canonical
// again. So the constants (twiddles, the scale, the powers of k) are made
// Montgomery once, and the elementwise product of two canonical arrays takes
// a second product by R^2 mod q (FR_R2K).
//
// Powers. k^e for e < 2^(slo + shi) is lo[e mod 2^slo] hi[e >> slo], with
// lo[i] = k^i and hi[i] = k^(i 2^slo) built by fr_powers_tab_kernel from
// bp[b] = k^(2^b) (Montgomery words computed on the host): one thread an
// entry, a product a set bit of its index. Exact: every factor is exact.
//
// NTT. In-order radix-2 Cooley-Tukey, as fr_ntt: a bit-reversal copy, then
// one launch a stage of n/2 butterflies, each thread one butterfly
// (i0 = (t >> s) << (s + 1) | j, i1 = i0 + 2^s, twiddle w^(j n / 2^(s+1))
// from a table of w^e, e < n/2). Every index is 64-bit. The output is
// fixed by the input, so the butterfly order does not change a word.
//
// Bound. The NTT does (n/2) log2 n Fr products (136 word products, 272
// 32-bit integer operations each) and must move 64 n bytes: at n = 2^22
// 1.26e10 operations, bound by operations (~0.75 ms on an H100 SXM) over
// bytes (~0.08 ms). This simple design reads and writes the whole array in
// every stage and builds its twiddle table each call; the elementwise
// functions are bound by bytes (64 or 96 n bytes).
#include "field.cuh"

#define POLY_THREADS 256

DEV void ld8(uint32_t* r, const uint32_t* p) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = p[k];
}

DEV void st8(uint32_t* p, const uint32_t* r) {
#pragma unroll
  for (int k = 0; k < 8; k++) p[k] = r[k];
}

// lo[i] = k^i (i < 2^slo), hi[i] = k^(i 2^slo) (i < 2^shi), Montgomery
__global__ void fr_powers_tab_kernel(const uint32_t* bp, int slo, int shi, uint32_t* lo, uint32_t* hi) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t nlo = 1LL << slo, nhi = 1LL << shi;
  if (i >= nlo + nhi) return;
  const bool low = i < nlo;
  const int64_t e = low ? i : i - nlo;
  const int b0 = low ? 0 : slo, nb = low ? slo : shi;
  uint32_t acc[8], f[8];
  f_one<FrT>(acc);
  for (int b = 0; b < nb; b++) {
    if ((e >> b) & 1) {
      ld8(f, bp + 8 * (b0 + b));
      f_mul<FrT>(acc, acc, f);
    }
  }
  st8((low ? lo : hi) + 8 * e, acc);
}

// k^e, Montgomery, from the two tables
DEV void power_of(uint32_t* r, const uint32_t* lo, const uint32_t* hi, int slo, int64_t e) {
  uint32_t a[8], b[8];
  ld8(a, lo + 8 * (e & ((1LL << slo) - 1)));
  ld8(b, hi + 8 * (e >> slo));
  f_mul<FrT>(r, a, b);
}

// tw[e] = w^e, Montgomery, e < m
__global__ void fr_twiddle_kernel(const uint32_t* lo, const uint32_t* hi, int slo, uint32_t* tw, int64_t m) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= m) return;
  uint32_t r[8];
  power_of(r, lo, hi, slo, e);
  st8(tw + 8 * e, r);
}

// out[rev(i)] = in[i], rev over lg bits
__global__ void fr_bitrev_kernel(const uint32_t* in, uint32_t* out, int64_t n, int lg) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t j = lg ? (int64_t)(__brev((unsigned)i) >> (32 - lg)) : 0;
  uint32_t v[8];
  ld8(v, in + 8 * i);
  st8(out + 8 * j, v);
}

// one stage of butterflies over blocks of 2^(s+1), in place
__global__ void fr_ntt_stage_kernel(uint32_t* a, const uint32_t* tw, int64_t half_n, int s, int lg) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= half_n) return;
  const int64_t h = 1LL << s;
  const int64_t j = t & (h - 1);
  const int64_t i0 = ((t >> s) << (s + 1)) + j, i1 = i0 + h;
  const int64_t e = j << (lg - 1 - s);  // j n / 2^(s+1) < n / 2
  uint32_t u[8], v[8], w[8], x[8];
  ld8(u, a + 8 * i0);
  ld8(v, a + 8 * i1);
  ld8(w, tw + 8 * e);
  f_mul<FrT>(v, v, w);
  f_add<FrT>(x, u, v);
  f_sub<FrT>(v, u, v);
  st8(a + 8 * i0, x);
  st8(a + 8 * i1, v);
}

// out = a b: (a b / R) R^2 / R
__global__ void fr_mul_array_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r2[8];
  ld8(x, a + 8 * i);
  ld8(y, b + 8 * i);
#pragma unroll
  for (int k = 0; k < 8; k++) r2[k] = FR_R2K[k];
  f_mul<FrT>(x, x, y);
  f_mul<FrT>(x, x, r2);
  st8(out + 8 * i, x);
}

// out = a k, k given as k R mod q
__global__ void fr_scale_kernel(const uint32_t* a, const uint32_t* km, uint32_t* out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], k[8];
  ld8(x, a + 8 * i);
  ld8(k, km);
  f_mul<FrT>(x, x, k);
  st8(out + 8 * i, x);
}

// out[i] = a[i] k^i
__global__ void fr_powers_mul_kernel(const uint32_t* a, const uint32_t* lo, const uint32_t* hi, int slo,
                                     uint32_t* out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], p[8];
  ld8(x, a + 8 * i);
  power_of(p, lo, hi, slo, i);
  f_mul<FrT>(x, x, p);
  st8(out + 8 * i, x);
}

static unsigned blocks(int64_t n) { return (unsigned)((n + POLY_THREADS - 1) / POLY_THREADS); }

static int tables(const uint32_t* bp, int slo, int shi, uint32_t* lo, uint32_t* hi, cudaStream_t st) {
  fr_powers_tab_kernel<<<blocks((1LL << slo) + (1LL << shi)), POLY_THREADS, 0, st>>>(bp, slo, shi, lo, hi);
  return (int)cudaGetLastError();
}

extern "C" {

// out = NTT(in) over the n = 2^lg points w^i; bp: w^(2^b) for b < slo + shi
// (slo + shi >= lg - 1); lo, hi: 2^slo and 2^shi scratch entries; tw: n / 2
int ph2_fr_ntt(const uint32_t* in, uint32_t* out, int64_t n, int lg, const uint32_t* bp, int slo, int shi,
               uint32_t* lo, uint32_t* hi, uint32_t* tw, void* stream) {
  if (n <= 0 || lg < 0 || lg > 30 || (1LL << lg) != n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  fr_bitrev_kernel<<<blocks(n), POLY_THREADS, 0, st>>>(in, out, n, lg);
  int rc = (int)cudaGetLastError();
  if (rc || lg == 0) return rc;
  if ((rc = tables(bp, slo, shi, lo, hi, st))) return rc;
  fr_twiddle_kernel<<<blocks(n / 2), POLY_THREADS, 0, st>>>(lo, hi, slo, tw, n / 2);
  if ((rc = (int)cudaGetLastError())) return rc;
  for (int s = 0; s < lg; s++) {
    fr_ntt_stage_kernel<<<blocks(n / 2), POLY_THREADS, 0, st>>>(out, tw, n / 2, s, lg);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}

int ph2_fr_mul_array(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  fr_mul_array_kernel<<<blocks(n), POLY_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

int ph2_fr_scale_array(const uint32_t* a, const uint32_t* km, uint32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  fr_scale_kernel<<<blocks(n), POLY_THREADS, 0, (cudaStream_t)stream>>>(a, km, out, n);
  return (int)cudaGetLastError();
}

// out[i] = a[i] k^i; bp: k^(2^b) for b < slo + shi, 2^(slo + shi) >= n
int ph2_fr_powers_mul_array(const uint32_t* a, uint32_t* out, int64_t n, const uint32_t* bp, int slo, int shi,
                            uint32_t* lo, uint32_t* hi, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = tables(bp, slo, shi, lo, hi, st);
  if (rc) return rc;
  fr_powers_mul_kernel<<<blocks(n), POLY_THREADS, 0, st>>>(a, lo, hi, slo, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
