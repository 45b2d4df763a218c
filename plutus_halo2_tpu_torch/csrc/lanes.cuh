// A Montgomery product spread over a group of T lanes (the layout of
// NVlabs' CGBN, "Cooperative Groups Big Numbers": TPI threads per
// instance). Used by the pow kernel (pow.cu).
//
// Layout. An element of NW words (field.cuh's domain) lives on T
// consecutive lanes of one warp, S = NW / T words a lane: lane l holds
// words l S .. l S + S - 1 in registers. T is 2 or 4 for Fp (NW = 12) and
// 2, 4 or 8 for Fr (NW = 8).
//
// The product (f_mul_lanes) is CIOS, a word of the multiplier a a step:
// every lane holds all NW words of a (gathered once before the product,
// lanes_gather) and its S words of b and N. Step i adds a_i b and m_i N to
// the running sum, m_i = t_0 n0 formed on lane 0 and broadcast by
// __shfl_sync. Each lane keeps its part of the sum in a window of 2 S + 1
// words (its own S, then S + 1 that overlap the next lane's), so a step
// costs each lane 2 S word products (two rows, mac_row) and one shuffle,
// and the only dependence between lanes inside a block of S steps is m_i.
// After S steps lane 0's S words are zero: the sum moves down by S words
// at once, each lane taking its upper window plus the next lane's lower
// words (S __shfl_down_sync), its top word left as a carry pending into
// the next lane. At the end the pending carries are resolved once, by a
// carry-lookahead over the group (two __ballot_sync: generate and
// propagate bits), and N is subtracted where the sum is at least N (the
// same lookahead on the borrows). The result is fully reduced, as every
// field.cuh op's, so the words equal f_mul's.
#pragma once
#include "field.cuh"

// This lane's place in its group of T lanes: the lane index, the group's
// first lane in the warp, masks that zero what the top lane gets from a
// shuffle down and the bottom lane from a shuffle up (a mask, not a
// branch: nvcc moved a shuffle into such a branch, and the warp through
// its slow divergent path), and this lane's words of N. The shuffles and
// ballots name the whole warp (FULL), so every lane of a warp calls them at
// once, each group on its own elements: on an H100 a shuffle whose mask is
// the group's alone split the warp into its groups, which then ran one
// after another (tools/curve_probe.py, PERF.md).
constexpr unsigned FULL = 0xffffffffu;

template <class F, int T>
struct Lanes {
  static constexpr int S = F::NW / T;
  static_assert(F::NW % T == 0 && T >= 2 && T <= 8, "T lanes must split the element's words");
  int l;
  unsigned base;
  uint32_t below_top, above_bottom;
  uint32_t n[S];
  DEV explicit Lanes(int lane) : l(lane) {
    base = (threadIdx.x & 31) & ~(T - 1);
    below_top = l == T - 1 ? 0u : ~0u;
    above_bottom = l == 0 ? 0u : ~0u;
#pragma unroll
    for (int s = 0; s < S; s++) n[s] = F::mod(l * S + s);
  }
  // bit k: lane k's predicate
  DEV unsigned ballot(bool p) const { return (__ballot_sync(FULL, p) >> base) & ((1u << T) - 1u); }
};

// full = all NW words of the element whose words this lane holds in slice
// (all 32 lanes of the warp call it, as every function here)
template <class F, int T>
DEV void lanes_gather(uint32_t* full, const uint32_t* slice, const Lanes<F, T>& g) {
  constexpr int S = Lanes<F, T>::S;
#pragma unroll
  for (int w = 0; w < F::NW; w++) full[w] = __shfl_sync(FULL, slice[w % S], w / S, T);
}

// t[0 .. S + 1] += x v for S words of v, where the sum fits in S + 2 words
// (f_mul_lanes' window keeps it so): no carry leaves t[S + 1]. Plain C: on
// an H100 PTX carry chains (mad.lo / madc.hi) here were no faster, the Fp
// pow kernel 3 % slower and the Fr one 2 % faster (PERF.md).
template <int S>
DEV void mac_row(uint32_t* t, uint32_t x, const uint32_t* v) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < S; j++) {
    const uint64_t s = (uint64_t)x * v[j] + t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  const uint64_t s = (uint64_t)t[S] + c;
  t[S] = (uint32_t)s;
  t[S + 1] += (uint32_t)(s >> 32);
}


// Carry-in bits of a group-wide addition from each lane's generate and
// propagate bits (never both set on one lane): bit k is the carry into
// lane k, bit T the carry out of the top lane.
DEV unsigned lookahead(unsigned gen, unsigned prop) { return (prop + (gen << 1)) ^ prop; }

// r = a b / R mod N, fully reduced, for a, b < N: a all NW words (every
// lane the same), b and r this lane's S words (r may alias b).
template <class F, int T>
DEV void f_mul_lanes(uint32_t* r, const uint32_t* a, const uint32_t* b, const Lanes<F, T>& g) {
  constexpr int S = Lanes<F, T>::S;
  uint32_t t[2 * S + 1];
#pragma unroll
  for (int k = 0; k < 2 * S + 1; k++) t[k] = 0;
#pragma unroll
  for (int blk = 0; blk < T; blk++) {
#pragma unroll
    for (int o = 0; o < S; o++) {
      // t[o ..] += a_i b, then m N with m from lane 0's word o (the sum's
      // lowest word). Before, t[o + S] is at most 3 and t[o + S + 1] is 0,
      // so both sums fit in t[o .. o + S + 1], which ends at most 2
      mac_row<S>(t + o, a[blk * S + o], b);
      const uint32_t m = __shfl_sync(FULL, t[o] * F::n0(), 0, T);
      mac_row<S>(t + o, m, g.n);
    }
    // down by S words: the upper window plus the next lane's lower words;
    // the top word stays pending into the next lane
    uint64_t c = 0;
#pragma unroll
    for (int s = 0; s < S; s++) {
      const uint32_t up = __shfl_down_sync(FULL, t[s], 1, T) & g.below_top;
      const uint64_t v = (uint64_t)t[S + s] + up + c;
      t[s] = (uint32_t)v;
      c = v >> 32;
    }
    t[S] = t[2 * S] + (uint32_t)c;
#pragma unroll
    for (int k = S + 1; k <= 2 * S; k++) t[k] = 0;
  }
  // the pending carries, each into the next lane's words
  uint64_t c = __shfl_up_sync(FULL, t[S], 1, T) & g.above_bottom;
  bool ones = true;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const uint64_t v = (uint64_t)t[s] + c;
    t[s] = (uint32_t)v;
    c = v >> 32;
    ones = ones && t[s] == 0xffffffffu;
  }
  const unsigned carry = lookahead(g.ballot(c != 0), g.ballot(ones));
  c = (carry >> g.l) & 1;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const uint64_t v = (uint64_t)t[s] + c;
    t[s] = (uint32_t)v;
    c = v >> 32;
  }
  // t < 2N: subtract N unless that borrows out of the top lane
  uint32_t d[S];
  uint64_t br = 0;
  bool eq = true;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const uint64_t v = (uint64_t)t[s] - g.n[s] - br;
    d[s] = (uint32_t)v;
    br = v >> 63;
    eq = eq && t[s] == g.n[s];
  }
  const unsigned borrow = lookahead(g.ballot(br != 0), g.ballot(eq));
  const bool lt = (borrow >> T) & 1;  // t < N: keep t
  br = (borrow >> g.l) & 1;
#pragma unroll
  for (int s = 0; s < S; s++) {
    const uint64_t v = (uint64_t)d[s] - br;
    r[s] = lt ? t[s] : (uint32_t)v;
    br = v >> 63;
  }
}
