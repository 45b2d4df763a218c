// MSM kernel: replaces plutus_halo2_tpu/ops/pallas_curve.py:233
// (make_msm_kernel, pallas_call at :327).
//
// What it computes: B independent multi-scalar multiplications
// sum_k s_k P_k over K points per row. Points are (B, K, 3, 25) projective
// Montgomery limbs, scalars (B, K, 17) canonical Fr limbs; the result is a
// (B, 3, 25) projective point, the same limbs as the plain version of this
// decomposition (ops/curve.msm_windowed) and equal in affine coordinates to
// any other MSM.
//
// Algorithm: the Pallas kernel's. Signed windows of WBITS bits (5 on the
// verifier's path: 52 windows, digits in [-16, 16] over a 17-entry table;
// 4 for the stage probe: 64 windows, digits in [-8, 8], 9 entries; the
// sign a free Y negation); per point a table of multiples 1..2^(WBITS-1);
// per window the sum over the row's points of the selected entries; ONE
// doubling chain per row over the window sums. Points are taken in chunks
// of MSM_CHUNK (the tables of one chunk in shared memory at a time; the
// window sums stay across chunks), as the Pallas kernel's chunk grid axis
// does.
//
// Bound: integer multiply throughput. The function needs about 14,500 Fp
// products a row at K = 16 (RCB15 add 12, double 8; counted from the data
// by chip_smoke.py), each a CIOS product of 300 32x32 multiplies. With
// ~1,000 rows there is not enough independent work to hide a product's
// latency, so the time is a row's critical path.
//
// Design: a group of MSM_LANES lanes per row (group.cuh), rows per block
// chosen to fill the SMs once. The group builds its chunk's tables in
// log2(2^(WBITS-1)) levels of independent additions,
// adds each point's terms to all window sums at once (one item per window,
// two products a lane), then runs the chain's doublings and additions with
// one product a lane: 612 product stages at 5-bit windows, where one
// thread's chain per point was ~2,900 products. Everything lives in shared
// memory slots and registers; no table is indexed in local memory. Any
// B >= 1, 1 <= K.
#include "group.cuh"

// signed windows of WBITS bits over a 256-bit scalar (pallas_curve.py:244-245)
template <int WBITS>
struct Win {
  static_assert(WBITS == 4 || WBITS == 5, "the Pallas kernel's widths");
  static constexpr int HALF = 1 << (WBITS - 1);            // table entries 1..HALF: 8 / 16
  static constexpr int NWIN = WBITS == 4 ? 64 : 52;          // 64 * 4 = 256, 52 * 5 = 260 bits
};

constexpr int MSM_CHUNK = 4;  // points whose tables share memory at a time

// Row layout (words): window sums, the chain's accumulator, the chunk's
// tables, the scratch, the chunk's digits (bytes).
template <int WBITS>
struct MsmLayout {
  using W = Win<WBITS>;
  static constexpr int WSUM = 0;
  static constexpr int ACC = WSUM + PT * W::NWIN;
  static constexpr int TAB = ACC + PT;
  static constexpr int SCRATCH = TAB + PT * MSM_CHUNK * W::HALF;
  static constexpr int DIG = SCRATCH + ADD_SCRATCH * GROUP_NB;
  static constexpr int WORDS = DIG + ((MSM_CHUNK * W::NWIN + 15) / 16) * 4;
};

template <int WBITS>
__global__ void __launch_bounds__(256, 1) msm_kernel(const int64_t* pts, const int64_t* sc, int64_t* out,
                                                     long long* phases, int B, int K, int lanes) {
  using W = Win<WBITS>;
  using L = MsmLayout<WBITS>;
  extern __shared__ __align__(16) uint32_t smem[];
  const Group g = make_group(lanes);
  const int slot = threadIdx.x / lanes;
  const int row = blockIdx.x * (blockDim.x / lanes) + slot;
  if (row >= B) return;  // the whole group leaves; only group barriers follow
  uint32_t* base = smem + (size_t)slot * L::WORDS;
  uint32_t *wsum = base + L::WSUM, *acc = base + L::ACC, *tab = base + L::TAB, *scratch = base + L::SCRATCH;
  int8_t* dig = reinterpret_cast<int8_t*>(base + L::DIG);
  // phases (optional, (B, 3)): clock64() at the start, before the chain, at the end
  long long* ph = (phases != nullptr && g.lane == 0) ? phases + (size_t)row * 3 : nullptr;
  if (ph) ph[0] = clock64();

  group_identity(g, wsum, W::NWIN);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += MSM_CHUNK) {
    const int c = min(MSM_CHUNK, K - k0);
    // entry 1 of each table: the point, one coordinate a lane
#pragma unroll 1
    for (int u = g.lane; u < 3 * c; u += g.G) {
      const int k = u / 3, co = u % 3;
      uint32_t v[SLOT];
      load_port<FpT>(v, pts + (((size_t)row * K + k0 + k) * 3 + co) * 25);
      s_store(tab + PT * k * W::HALF + SLOT * co, v);
    }
    // the signed digits, one scalar a lane, from its 16-bit limbs (limb 16
    // is 0): d = raw + carry in [0, 2 HALF]; d > HALF becomes d - 2 HALF
    // with a carry into the next window; the top window's raw value is
    // below HALF (s < 2^255), so no carry is left
#pragma unroll 1
    for (int k = g.lane; k < c; k += g.G) {
      const int64_t* s = sc + ((size_t)row * K + k0 + k) * 17;
      int carry = 0;
#pragma unroll 1
      for (int w = 0; w < W::NWIN; w++) {
        const int pos = WBITS * w, li = pos >> 4;
        const uint32_t two = (uint32_t)s[li] | ((uint32_t)s[li + 1] << 16);
        const int d = (int)((two >> (pos & 15)) & ((1u << WBITS) - 1)) + carry;
        carry = d > W::HALF;
        dig[k * W::NWIN + w] = (int8_t)(carry ? d - 2 * W::HALF : d);
      }
    }
    g.sync();
    group_tables(g, scratch, tab, c, W::HALF);
    group_window_terms(g, scratch, wsum, W::NWIN, tab, W::HALF, dig, c);  // ends with a barrier
  }
  if (ph) ph[1] = clock64();
  group_window_chain(g, scratch, acc, wsum, 1, W::NWIN, WBITS);
  if (ph) ph[2] = clock64();
  for (int co = g.lane; co < 3; co += g.G) store_port<FpT>(out + ((size_t)row * 3 + co) * 25, acc + SLOT * co);
}

// lanes a row: the fastest width on an H100 at (1024, 16) and at (256, 8),
// where the 52 window sums keep 32 lanes busy (4 to 32 swept, kernel alone)
constexpr int MSM_LANES = 32;

template <int WBITS>
static int launch(const int64_t* pts, const int64_t* sc, int64_t* out, long long* phases, int B, int K,
                  cudaStream_t stream) {
  const size_t row_bytes = sizeof(uint32_t) * MsmLayout<WBITS>::WORDS;
  const int rows = group_rows(B, MSM_LANES, row_bytes);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = rows * row_bytes;
  cudaError_t e = cudaFuncSetAttribute(msm_kernel<WBITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  msm_kernel<WBITS><<<(B + rows - 1) / rows, rows * MSM_LANES, smem, stream>>>(pts, sc, out, phases, B, K,
                                                                               MSM_LANES);
  return (int)cudaGetLastError();
}

// rows a block from group_rows; phases: nullptr, or (B, 3) cycle marks
extern "C" int ph2_msm(const int64_t* pts, const int64_t* sc, int64_t* out, long long* phases, int B, int K,
                       int wbits, void* stream) {
  if (wbits != 4 && wbits != 5) return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return wbits == 4 ? launch<4>(pts, sc, out, phases, B, K, s) : launch<5>(pts, sc, out, phases, B, K, s);
}
