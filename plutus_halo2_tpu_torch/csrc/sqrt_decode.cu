// Hintless G1 decompression kernel: the whole of ops/curve.decompress
// without a hint in one launch, where the verifier without y-hints ran ~600
// plain-torch ops around the Fp pow kernel. It replaces the Fp use of
// plutus_halo2_tpu/ops/pallas_field.py:32 make_pow_kernel (the (p+1)/4
// ladder) together with the decoding around it, which the JAX package runs
// under XLA (verifier_jax.py, ops/curve.decompress with that kernel as its
// square root).
//
// What it computes, per compressed point (blst conventions,
// CompressUncompress.hs:51-97): the flags of byte 0; x from the 381-bit
// big-endian payload and the test x >= p; rhs = x^3 + 4; the candidate root
// y = rhs^((p+1)/4) by the 4-bit fixed window (digits as the pow kernel
// takes them); root_ok = y^2 == rhs; the sign chosen by the flag (y >=
// (p+1)/2 is the "larger" root); valid = compressed and, for an infinity
// encoding, no sign and a zero payload, else x < p and root_ok. Input:
// pt_raw, n compressed points of 48 bytes. Outputs: points (n, 3, 25) in
// the port's Montgomery domain, bit-identical to ops/curve.decompress
// without a hint on every point, valid or not (the identity for an infinity
// encoding, else (x, +-y, 1)), and valid (n,) bool.
//
// Bound: integer multiply throughput. Per point the ladder's 14 table
// products and, per digit of (p+1)/4 after the first (94 of 95), 4
// squarings and a table product unless the digit is 0 (481 products), then
// 7 more: x into the domain, x^2, x^3, y^2, y out of it for the sign, and x
// and y into the port's domain; each a CIOS product of 300 32x32 word
// multiplies.
//
// Design: the pow kernel's (pow.cu). A point belongs to a group of
// SQRT_DECODE_LANES lanes (lanes.cuh: each product shared by the group, S =
// 3 words a lane), SQRT_DECODE_ROWS points a block: one warp. Every lane
// reads the whole encoding and keeps x whole, the multiplier of the first
// product; the few whole-value steps (the sum x^3 + 4, the comparison with
// (p+1)/2, the negation) run on every lane of the group on gathered values,
// each lane then keeping its words. The power table [1, rhs, ..., rhs^15]
// is in shared memory, each lane reading and writing its own words of an
// entry. The ragged edge's groups run on the last point and store nothing:
// the shuffles need every lane of the warp. Any n >= 0.
#include "lanes.cuh"

// The launch geometry: the pow kernel's (POW_LANES, POW_ROWS), which its
// sweeps found fastest for the same ladder at the verifier's shapes
constexpr int SQRT_DECODE_LANES = 4;
constexpr int SQRT_DECODE_ROWS = 8;

// words of one point's table in shared memory: 16 entries of 12 words,
// padded to 12 mod 32 so that a warp's groups read different banks
constexpr int SQRT_TAB_WORDS = 16 * 12 + 12;

// this lane's S words of a whole value
template <int S>
DEV void own_words(uint32_t* s, const uint32_t* full, int l) {
#pragma unroll
  for (int k = 0; k < S; k++) s[k] = full[l * S + k];
}

template <int T>
__global__ void __launch_bounds__(256) sqrt_decode_kernel(const uint8_t* raw, int64_t* pts, uint8_t* valid,
                                                          int n, const int* digits, int nd) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int NW = FpT::NW, S = NW / T;
  const int slot = threadIdx.x / T;
  const int i = blockIdx.x * (blockDim.x / T) + slot;
  const bool live = i < n;
  const Lanes<FpT, T> g(threadIdx.x % T);
  uint32_t* tab = smem + (size_t)slot * SQRT_TAB_WORDS + g.l * S;  // this lane's words of entry 0
  // the flags; x: big-endian bytes, the three flag bits cleared; word k
  // holds bytes 44-4k .. 47-4k
  const uint8_t* src = raw + (size_t)(live ? i : n - 1) * 48;
  const uint32_t flags = src[0];
  const bool comp = flags & 0x80, inf = flags & 0x40, sign = flags & 0x20;
  uint32_t xw[NW], full[NW], c[S], xm[S], rhs[S], acc[S];
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    const int b = 47 - 4 * k;
    const uint32_t top = b - 3 == 0 ? (flags & 0x1F) : src[b - 3];
    xw[k] = (uint32_t)src[b] | ((uint32_t)src[b - 1] << 8) | ((uint32_t)src[b - 2] << 16) | (top << 24);
    any |= xw[k];
  }
  // x >= p: x - p does not borrow
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) br = ((uint64_t)xw[k] - FP_MOD[k] - br) >> 63;
  const bool x_ge_p = br == 0;
  // to the kernel's domain: x R^2 / R (x < 2^384 = R, so the CIOS result
  // stays below 2p and is fully reduced); then rhs = x^3 + 4
#pragma unroll
  for (int s = 0; s < S; s++) c[s] = FP_R2K[g.l * S + s];
  f_mul_lanes<FpT, T>(xm, xw, c, g);
  lanes_gather<FpT, T>(full, xm, g);
  f_mul_lanes<FpT, T>(acc, full, xm, g);
  f_mul_lanes<FpT, T>(acc, full, acc, g);
  lanes_gather<FpT, T>(full, acc, g);
  f_add<FpT>(full, full, FP_B4);
  own_words<S>(rhs, full, g.l);
  // y = rhs^((p+1)/4): the table [1, rhs, ..., rhs^15], then the window
  // ladder over the digits, a zero digit's product by 1 skipped
#pragma unroll
  for (int s = 0; s < S; s++) {
    tab[s] = FpT::one(g.l * S + s);
    tab[NW + s] = acc[s] = rhs[s];
  }
#pragma unroll 1
  for (int k = 2; k < 16; k++) {
    f_mul_lanes<FpT, T>(acc, full, acc, g);
#pragma unroll
    for (int s = 0; s < S; s++) tab[k * NW + s] = acc[s];
  }
  int d = LDG(digits);
#pragma unroll
  for (int s = 0; s < S; s++) acc[s] = tab[d * NW + s];
#pragma unroll 1
  for (int k = 1; k < nd; k++) {
#pragma unroll 1
    for (int q = 0; q < 4; q++) {
      lanes_gather<FpT, T>(full, acc, g);
      f_mul_lanes<FpT, T>(acc, full, acc, g);
    }
    d = LDG(digits + k);
    if (d != 0) {
      uint32_t e[S];
#pragma unroll
      for (int s = 0; s < S; s++) e[s] = tab[d * NW + s];
      lanes_gather<FpT, T>(full, acc, g);
      f_mul_lanes<FpT, T>(acc, full, e, g);
    }
  }
  // root_ok: y^2 == rhs on every lane's words
  lanes_gather<FpT, T>(full, acc, g);
  f_mul_lanes<FpT, T>(c, full, acc, g);
  bool same = true;
#pragma unroll
  for (int s = 0; s < S; s++) same = same && c[s] == rhs[s];
  const bool root_ok = g.ballot(!same) == 0;
  // sign: the canonical y (y 1 / R) is "larger" iff y >= (p + 1) / 2
  uint32_t one_raw[NW], y[NW];
  f_zero<FpT>(one_raw);
  one_raw[0] = 1;
  f_mul_lanes<FpT, T>(c, one_raw, acc, g);
  lanes_gather<FpT, T>(y, c, g);
  br = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) br = ((uint64_t)y[k] - FP_HALF[k] - br) >> 63;
  const bool y_gt = br == 0;
  // the point (x, +-y, 1), or the identity (0, 1, 0), into the port's
  // domain: times from_k, which is also the port's 1
  f_neg<FpT>(y, full);
  const bool flip = sign != y_gt;
#pragma unroll
  for (int k = 0; k < NW; k++) y[k] = flip ? y[k] : full[k];
  lanes_gather<FpT, T>(full, xm, g);
#pragma unroll
  for (int s = 0; s < S; s++) c[s] = FpT::from_k(g.l * S + s);
  f_mul_lanes<FpT, T>(xm, full, c, g);
  f_mul_lanes<FpT, T>(acc, y, c, g);
  if (!live) return;
  const uint32_t keep = inf ? 0u : ~0u;
  int64_t* dst = pts + (size_t)i * 75;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const uint32_t w[3] = {xm[s] & keep, inf ? c[s] : acc[s], c[s] & keep};
#pragma unroll
    for (int j = 0; j < 3; j++) {
      dst[25 * j + 2 * (g.l * S + s)] = w[j] & 0xffffu;
      dst[25 * j + 2 * (g.l * S + s) + 1] = w[j] >> 16;
    }
  }
  if (g.l == T - 1)
    for (int j = 0; j < 3; j++) dst[25 * j + 2 * NW] = 0;
  if (g.l == 0) valid[i] = comp && (inf ? (!sign && any == 0) : (root_ok && !x_ge_p));
}

extern "C" int ph2_sqrt_decode(const uint8_t* raw, int64_t* pts, uint8_t* valid, int n, const int* digits, int nd,
                               void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(uint32_t) * SQRT_DECODE_ROWS * SQRT_TAB_WORDS;
  sqrt_decode_kernel<SQRT_DECODE_LANES>
      <<<(n + SQRT_DECODE_ROWS - 1) / SQRT_DECODE_ROWS, SQRT_DECODE_ROWS * SQRT_DECODE_LANES, smem,
         (cudaStream_t)stream>>>(raw, pts, valid, n, digits, nd);
  return (int)cudaGetLastError();
}
