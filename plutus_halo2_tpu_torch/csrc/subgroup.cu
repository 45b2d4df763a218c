// Aggregate subgroup-membership kernel: replaces
// plutus_halo2_tpu/ops/pallas_curve.py:642 (make_subgroup_kernel,
// pallas_call at :795).
//
// What it computes: for each row of K decoded points (B, K, 3, 25)
// (projective, the port's Montgomery domain, any representative) and
// weights (rounds, K) in [1, 2^16), ok = AND over rounds of
// "Q_r = sum_k w_{r,k} P_k lies in G1" (group.cuh, group_aggregate_ok), as
// ops/curve.aggregate_subgroup_check does. Output (B,) bool.
//
// Bound: integer multiply throughput. Per row and round, a 3-add table and
// the weight's signed 3-bit windows per point (the non-zero digits' adds
// and one shared doubling chain of 15 doublings in the Pallas kernel's
// algorithm), and two 64-bit z-ladders of 63 doublings and 5 additions.
//
// Design: the fused decompress kernel's (decompress.cu) without the
// decoding. Each row belongs to a group of SUBGROUP_LANES lanes (group.cuh;
// rows per block chosen to fill the SMs once): one lane a point loads its point
// into the row's tables in shared memory, then the group runs the test as
// stages of Fp products spread over its lanes, the rounds' ladders sharing
// stages. Any B >= 1, 1 <= K <= 128, rounds 1 to 4.
#include "group.cuh"

__global__ void __launch_bounds__(256, 1) subgroup_kernel(const int64_t* pts, const int* weights, uint8_t* ok_out,
                                                          long long* phases, int B, int K, int rounds, int lanes) {
  aggregate_rows([&](Pt& P, size_t i) { pt_load_port(P, pts + i * 75); }, weights, ok_out, phases, B, K, rounds,
                 lanes);
}

// lanes a row: two rows a warp ran the ladder stages of 4-6 products faster
// than 32 lanes at 1024 rows on an H100 (4 to 32 swept, kernel alone)
constexpr int SUBGROUP_LANES = 16;

// rows a block from group_rows; phases nullptr or (B, 4) cycle marks.
extern "C" int ph2_subgroup(const int64_t* pts, const int* weights, uint8_t* ok, long long* phases, int B, int K,
                            int rounds, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  return launch_aggregate_rows(subgroup_kernel, B, K, rounds, SUBGROUP_LANES, (cudaStream_t)stream, pts, weights,
                               ok, phases, B, K, rounds, SUBGROUP_LANES);
}
