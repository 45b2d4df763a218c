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
// 15*12 + 52*(5*8 + 12) + 3 = 2,887 products per point, ~46,000 per row.
//
// Design: one thread per (row, point) computes s_k P_k with signed 5-bit
// windows (digits in [-16, 16], the sign a free Y negation) over a table
// in local memory, using the complete RCB15 formulas (a = 0, b3 = 12), so
// the identity, a zero scalar and doublings need no branch. Then the row's
// K partial results are summed by a halving tree in shared memory. Rows of
// up to 32 points share a warp; any B works (the ragged edge is masked).
#include "curve.cuh"  // Pt, pt_identity, pt_add, pt_double

constexpr int WBITS = 5, NWIN = 52, TENT = 17;  // 52 * 5 = 260 >= 256 bits

// 5 bits of the 256-bit scalar s starting at bit `pos` (bits >= 256 are 0).
DEV int scalar_bits(const uint32_t* s, int pos) {
  const int w = pos >> 5, off = pos & 31;
  uint32_t v = s[w] >> off;
  if (off > 32 - WBITS && w + 1 < 8) v |= s[w + 1] << (32 - off);
  return v & 31;
}

// r = [s] P with signed 5-bit windows: digit d = raw + carry in [0, 32];
// d > 16 becomes -(32 - d) with a carry into the next window. The top
// window's raw value is 0 (s < 2^255), so no carry is left over.
DEV_NOINLINE void scalar_mul(Pt& r, const Pt& P, const uint32_t* s) {
  Pt tab[TENT];
  pt_identity(tab[0]);
  tab[1] = P;
#pragma unroll 1
  for (int k = 2; k < TENT; k++) pt_add(tab[k], tab[k - 1], P);
  uint8_t mag[NWIN];
  uint8_t neg[NWIN];
  int carry = 0;
#pragma unroll 1
  for (int w = 0; w < NWIN; w++) {
    const int d = scalar_bits(s, WBITS * w) + carry;
    carry = d > 16;
    mag[w] = carry ? 32 - d : d;
    neg[w] = carry;
  }
  Pt acc, t;
  pt_identity(acc);
#pragma unroll 1
  for (int w = NWIN - 1; w >= 0; w--) {
#pragma unroll 1
    for (int k = 0; k < WBITS; k++) pt_double(acc, acc);
    t = tab[mag[w]];
    if (neg[w]) f_neg<FpT>(t.y, t.y);
    pt_add(acc, acc, t);
  }
  r = acc;
}

// blockDim.x = KP * rows; KP = K rounded up to a power of two.
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
    scalar_mul(acc, P, s);
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

extern "C" int ph2_msm(const int64_t* pts, const int64_t* sc, int64_t* out, int B, int K, void* stream) {
  if (B > 0 && K > 0) {
    int KP = 1;
    while (KP < K) KP <<= 1;
    const int rows = KP >= 32 ? 1 : 32 / KP;  // one warp per block
    const int threads = KP * rows;
    const size_t shmem = (size_t)threads * sizeof(Pt);
    msm_kernel<<<(B + rows - 1) / rows, threads, shmem, (cudaStream_t)stream>>>(pts, sc, out, B, K, KP);
  }
  return (int)cudaGetLastError();
}
