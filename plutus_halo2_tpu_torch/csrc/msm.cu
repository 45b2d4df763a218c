// MSM kernel: replaces plutus_halo2_tpu/ops/pallas_curve.py:233
// (make_msm_kernel, pallas_call at :327).
//
// What it computes: B independent multi-scalar multiplications
// sum_k s_k P_k over K points per row. Points are (B, K, 3, 25) projective
// Montgomery limbs, scalars (B, K, 17) canonical Fr limbs; the result is a
// (B, 3, 25) projective point (any representative; compare in affine).
//
// Bound: integer multiply throughput. The function needs, per row, a
// 15-add signed-window table per point, one add per non-zero digit and ONE
// doubling chain (255 doublings) shared by the row's points, as the Pallas
// kernel does: about 14,500 Fp products for K = 16 random scalars (RCB15 add
// 12, double 8; counted from the data by chip_smoke.py), each a CIOS product
// of 300 32x32 multiplies. This kernel runs a doubling chain per point:
// at 5-bit windows 15*12 + 52*(5*8 + 12) + 3 = 2,887 products per point,
// ~46,000 per row; at 4-bit windows 7*12 + 64*(4*8 + 12) + 3 = 2,903.
//
// Design: one thread per (row, point) computes s_k P_k with signed windows
// of WBITS bits (a template parameter, as the Pallas kernel's wbits: 5 on
// the verifier's path, 52 windows with digits in [-16, 16] over a 17-entry
// table; 4 for the stage probe, 64 windows, digits in [-8, 8], 9 entries;
// the sign a free Y negation) over a table in local memory, using the
// complete RCB15 formulas (a = 0, b3 = 12), so the identity, a zero scalar
// and doublings need no branch. Then the row's K partial results are
// summed by a halving tree in shared memory. Rows of up to 32 points share
// a warp; any B works (the ragged edge is masked).
#include "curve.cuh"  // Pt, pt_identity, pt_add, pt_double

// signed windows of WBITS bits over a 256-bit scalar (pallas_curve.py:244-245)
template <int WBITS> struct Win {
  static_assert(WBITS == 4 || WBITS == 5, "the Pallas kernel's widths");
  static constexpr int HALF = 1 << (WBITS - 1), TENT = HALF + 1;  // table entries 0..HALF: 9 / 17
  static constexpr int NWIN = WBITS == 4 ? 64 : 52;                 // 64 * 4 = 256, 52 * 5 = 260 bits
};

// WBITS bits of the 256-bit scalar s starting at bit `pos` < 256 (bits >= 256 are 0).
template <int WBITS>
DEV int scalar_bits(const uint32_t* s, int pos) {
  const int w = pos >> 5, off = pos & 31;
  uint32_t v = s[w] >> off;
  if (off > 32 - WBITS && w + 1 < 8) v |= s[w + 1] << (32 - off);
  return v & ((1u << WBITS) - 1);
}

// r = [s] P with signed windows: digit d = raw + carry in [0, 2 HALF];
// d > HALF becomes -(2 HALF - d) with a carry into the next window. The top
// window's raw value is at most HALF - 1 (s < 2^255), so no carry is left
// over.
template <int WBITS>
DEV_NOINLINE void scalar_mul(Pt& r, const Pt& P, const uint32_t* s) {
  using W = Win<WBITS>;
  Pt tab[W::TENT];
  pt_identity(tab[0]);
  tab[1] = P;
#pragma unroll 1
  for (int k = 2; k < W::TENT; k++) pt_add(tab[k], tab[k - 1], P);
  uint8_t mag[W::NWIN];
  uint8_t neg[W::NWIN];
  int carry = 0;
#pragma unroll 1
  for (int w = 0; w < W::NWIN; w++) {
    const int d = scalar_bits<WBITS>(s, WBITS * w) + carry;
    carry = d > W::HALF;
    mag[w] = carry ? 2 * W::HALF - d : d;
    neg[w] = carry;
  }
  Pt acc, t;
  pt_identity(acc);
#pragma unroll 1
  for (int w = W::NWIN - 1; w >= 0; w--) {
#pragma unroll 1
    for (int k = 0; k < WBITS; k++) pt_double(acc, acc);
    t = tab[mag[w]];
    if (neg[w]) f_neg<FpT>(t.y, t.y);
    pt_add(acc, acc, t);
  }
  r = acc;
}

// blockDim.x = KP * rows; KP = K rounded up to a power of two.
template <int WBITS>
__global__ void msm_kernel(const int64_t* pts, const int64_t* sc, int64_t* out, int B, int K, int KP) {
  extern __shared__ uint32_t smem[];
  Pt* part = reinterpret_cast<Pt*>(smem);
  const int lane = threadIdx.x % KP;
  const int row = blockIdx.x * (blockDim.x / KP) + threadIdx.x / KP;
  Pt acc;
  pt_identity(acc);
  if (row < B && lane < K) {
    const size_t i = (size_t)row * K + lane;
    Pt P;
    pt_load_port(P, pts + i * 75);
    uint32_t s[8];
    load_words<8>(s, sc + i * 17);
    scalar_mul<WBITS>(acc, P, s);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int st = KP / 2; st >= 1; st >>= 1) {
    if (lane < st) pt_add(part[threadIdx.x], part[threadIdx.x], part[threadIdx.x + st]);
    __syncthreads();
  }
  if (lane == 0 && row < B) {
    pt_store_port(out + (size_t)row * 75, part[threadIdx.x]);
  }
}

extern "C" int ph2_msm(const int64_t* pts, const int64_t* sc, int64_t* out, int B, int K, int wbits,
                       void* stream) {
  if (wbits != 4 && wbits != 5) return (int)cudaErrorInvalidValue;
  if (B > 0 && K > 0) {
    int KP = 1;
    while (KP < K) KP <<= 1;
    const int rows = KP >= 32 ? 1 : 32 / KP;  // one warp per block
    const int threads = KP * rows;
    const size_t shmem = (size_t)threads * sizeof(Pt);
    auto kernel = wbits == 4 ? msm_kernel<4> : msm_kernel<5>;
    kernel<<<(B + rows - 1) / rows, threads, shmem, (cudaStream_t)stream>>>(pts, sc, out, B, K, KP);
  }
  return (int)cudaGetLastError();
}
