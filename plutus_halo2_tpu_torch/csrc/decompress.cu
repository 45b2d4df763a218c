// Hinted G1 decompression kernel: replaces
// plutus_halo2_tpu/ops/pallas_curve.py:367 (make_decompress_kernel,
// pallas_call at :605), both its plain and its subgroup-fused variant.
//
// What it computes, per compressed point (blst conventions,
// CompressUncompress.hs:51-97): the flags of byte 0; x from the 381-bit
// big-endian payload; valid = compressed and, for an infinity encoding, no
// sign and a zero payload, else x < p and hint^2 == x^3 + 4; the point
// (x, +-hint, 1) with the sign chosen by the flag (y >= (p+1)/2 is the
// "larger" root), or the identity for an infinity encoding. Inputs: pt_raw
// (B, K, 48) uint8 and y_hints (B, K, 25) canonical 16-bit limbs, of which
// the kernel reads the low 24 limbs' low 16 bits (the hint mod 2^384, as
// the Pallas kernel does; the plain version masks the same way). Outputs:
// points (B, K, 3, 25) in the port's Montgomery domain, bit-identical to
// ops/curve.decompress(..., y_hint=) on every point, valid or not, and
// valid (B, K) bool. With weights (rounds, K) in [1, 2^16) it also returns
// sub_ok (B,): the per-row aggregate subgroup test on the points just
// decoded, from shared memory.
//
// Bound: integer multiply throughput. Decoding is ~8 Fp products per
// point; the fused test adds, per row and round, the 3-add tables, the
// window sums of the weights' signed 3-bit digits, one shared chain of 3
// doublings a window, and two 64-bit z-ladders (63 doublings + 5 additions
// each): ~1,000 Fp products per row at K = 10, one round, each a CIOS
// product of 300 32x32 multiplies; a row's critical path is ~350 product
// stages.
//
// Design: the unfused variant runs one thread per (row, point) in flat
// blocks. The fused variant gives each row a group of DECOMPRESS_LANES
// lanes (group.cuh; two rows a warp; rows per block chosen to fill the SMs
// once): one lane a point decodes into the row's tables in shared memory,
// then the group runs the aggregate test
// (group_aggregate_ok) as stages of Fp products spread over the lanes, the
// rounds' ladders sharing stages. Any B >= 1 (the ragged edge is masked),
// 1 <= K <= 128, rounds 1 to 4.
#include "group.cuh"

// Decode one compressed point. Returns valid; P is the identity for an
// infinity encoding, else (x, y, 1) in the kernel's domain.
DEV bool decode_point(Pt& P, const uint8_t* raw, const int64_t* hint) {
  const uint32_t flags = raw[0];
  const bool comp = flags & 0x80, inf = flags & 0x40, sign = flags & 0x20;
  // x: big-endian bytes, the three flag bits cleared; word i holds bytes
  // 44-4i .. 47-4i
  uint32_t xw[12], hw[12];
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const int b = 47 - 4 * i;
    const uint32_t top = b - 3 == 0 ? (flags & 0x1F) : raw[b - 3];
    xw[i] = (uint32_t)raw[b] | ((uint32_t)raw[b - 1] << 8) | ((uint32_t)raw[b - 2] << 16) | (top << 24);
    any |= xw[i];
    hw[i] = (uint32_t)(hint[2 * i] & 0xffff) | ((uint32_t)(hint[2 * i + 1] & 0xffff) << 16);
  }
  // x >= p: x - p does not borrow
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) br = ((uint64_t)xw[i] - FP_MOD[i] - br) >> 63;
  const bool x_ge_p = br == 0;
  // to the kernel's Montgomery domain: a R^2 / R (a < 2^384 = R, so the
  // CIOS result stays below 2p and is fully reduced)
  uint32_t xm[12], ym[12], t[12], rhs[12];
  f_mul<FpT>(xm, xw, FP_R2K);
  f_mul<FpT>(ym, hw, FP_R2K);
  f_mul<FpT>(t, xm, xm);
  f_mul<FpT>(rhs, t, xm);
  f_add<FpT>(rhs, rhs, FP_B4);
  f_mul<FpT>(t, ym, ym);
  const bool root_ok = f_eq<FpT>(t, rhs);
  // sign: the canonical y is "larger" iff y >= (p + 1) / 2
  uint32_t one_raw[12];
  f_zero<FpT>(one_raw);
  one_raw[0] = 1;
  f_mul<FpT>(t, ym, one_raw);
  br = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) br = ((uint64_t)t[i] - FP_HALF[i] - br) >> 63;
  const bool y_gt = br == 0;
  if (inf) {
    pt_identity(P);
  } else {
    f_copy<FpT>(P.x, xm);
    if (sign != y_gt) {
      f_neg<FpT>(P.y, ym);
    } else {
      f_copy<FpT>(P.y, ym);
    }
    f_one<FpT>(P.z);
  }
  return comp && (inf ? (!sign && any == 0) : (root_ok && !x_ge_p));
}

__global__ void decompress_kernel(const uint8_t* raw, const int64_t* hints, int64_t* pts,
                                  uint8_t* valid, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt P;
  valid[i] = decode_point(P, raw + (size_t)i * 48, hints + (size_t)i * 25);
  pt_store_port(pts + (size_t)i * 75, P);
}

__global__ void __launch_bounds__(256, 1) decompress_subgroup_kernel(const uint8_t* raw, const int64_t* hints,
                                                                     const int* weights, int64_t* pts,
                                                                     uint8_t* valid, uint8_t* sub_ok,
                                                                     long long* phases, int B, int K, int rounds,
                                                                     int lanes) {
  aggregate_rows(
      [&](Pt& P, size_t i) {
        valid[i] = decode_point(P, raw + i * 48, hints + i * 25);
        pt_store_port(pts + i * 75, P);
      },
      weights, sub_ok, phases, B, K, rounds, lanes);
}

// The launch geometry: the unfused variant's threads a block (within 6 %
// of the fastest size at the verifier's shapes on an H100), the fused
// variant's lanes a row (as subgroup.cu's)
constexpr int DECOMPRESS_THREADS = 64;
constexpr int DECOMPRESS_LANES = 16;

// weights == nullptr (rounds == 0): the unfused variant, sub_ok untouched;
// else the fused one, rows a block from group_rows, phases nullptr or
// (B, 4) cycle marks.
extern "C" int ph2_decompress(const uint8_t* raw, const int64_t* hints, const int* weights,
                              int64_t* pts, uint8_t* valid, uint8_t* sub_ok, long long* phases, int B, int K,
                              int rounds, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (rounds == 0) {
    const int n = B * K;
    decompress_kernel<<<(n + DECOMPRESS_THREADS - 1) / DECOMPRESS_THREADS, DECOMPRESS_THREADS, 0, st>>>(
        raw, hints, pts, valid, n);
    return (int)cudaGetLastError();
  }
  return launch_aggregate_rows(decompress_subgroup_kernel, B, K, rounds, DECOMPRESS_LANES, st, raw, hints,
                               weights, pts, valid, sub_ok, phases, B, K, rounds, DECOMPRESS_LANES);
}
