// Shared BLS12-381 G1 device code for the curve kernels: projective points
// over the kernel's Fp domain (field.cuh) and their conversion from and to
// the port's limbs. The MSM, the fused decompress kernel and the subgroup
// kernel run the lane-group point operations of group.cuh on top of this
// file; the unfused decompress kernel stores its points through it.
#pragma once
#include "field.cuh"

struct Pt {
  uint32_t x[12], y[12], z[12];
};

DEV void pt_identity(Pt& p) {
  f_zero<FpT>(p.x);
  f_one<FpT>(p.y);
  f_zero<FpT>(p.z);
}

DEV void pt_load_port(Pt& p, const int64_t* src) {
  load_port<FpT>(p.x, src);
  load_port<FpT>(p.y, src + 25);
  load_port<FpT>(p.z, src + 50);
}

DEV void pt_store_port(int64_t* dst, const Pt& p) {
  store_port<FpT>(dst, p.x);
  store_port<FpT>(dst + 25, p.y);
  store_port<FpT>(dst + 50, p.z);
}
