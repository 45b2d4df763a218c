// Aggregate subgroup-membership kernel: replaces
// plutus_halo2_tpu/ops/pallas_curve.py:642 (make_subgroup_kernel,
// pallas_call at :795).
//
// What it computes: for each row of K decoded points (B, K, 3, 25)
// (projective, the port's Montgomery domain, any representative) and
// weights (rounds, K) in [1, 2^16), ok = AND over rounds of
// "Q_r = sum_k w_{r,k} P_k lies in G1" (curve.cuh), as
// ops/curve.aggregate_subgroup_check does. Output (B,) bool.
//
// Bound: integer multiply throughput. Per row and round, a 3-add table and
// the weight's signed 3-bit windows per point (the non-zero digits' adds
// and one shared doubling chain of 15 doublings in the Pallas kernel's
// algorithm), and two 64-bit z-ladders of 63 doublings and 5 additions.
//
// Design: the row layout of msm.cu and the fused decompress kernel — a
// thread per (row, point) loads its point and forms [w] P, a halving tree
// in shared memory sums the row, lane 0 runs the endomorphism test. Any
// B >= 1, 1 <= K <= 128, rounds 1 to 4.
#include "curve.cuh"

__global__ void subgroup_kernel(const int64_t* pts, const int* weights, uint8_t* ok_out, int B,
                                int K, int KP, int rounds) {
  extern __shared__ uint32_t smem[];
  Pt* part = reinterpret_cast<Pt*>(smem);
  const int lane = threadIdx.x % KP;
  const int row = blockIdx.x * (blockDim.x / KP) + threadIdx.x / KP;
  const bool live = row < B;
  Pt P;
  pt_identity(P);
  if (live && lane < K) pt_load_port(P, pts + ((size_t)row * K + lane) * 75);
  const bool ok = row_aggregate_ok(part, P, live, lane, KP, K, weights, rounds);
  if (lane == 0 && live) ok_out[row] = ok;
}

extern "C" int ph2_subgroup(const int64_t* pts, const int* weights, uint8_t* ok, int B, int K,
                            int rounds, int tpb, void* stream) {
  if (B > 0 && K > 0) {
    const RowShape s = row_shape(B, K, tpb);
    subgroup_kernel<<<s.blocks, s.threads, s.shmem, (cudaStream_t)stream>>>(pts, weights, ok, B,
                                                                             K, s.KP, rounds);
  }
  return (int)cudaGetLastError();
}
