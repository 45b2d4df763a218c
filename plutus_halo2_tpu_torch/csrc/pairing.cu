// Pairing-check kernel: replaces plutus_halo2_tpu/ops/pallas_pairing.py:419
// (make_pairing_check, pallas_call at :549).
//
// What it computes: for every row, e(el, Q1) * e(er, Q2) == 1, with el, er
// (B, 3, 25) projective Montgomery limbs and the G2 sides fixed per
// verifying key, given as host-prepared line ladders (per pair the 63
// doubling lines, then the addition lines of the 5 one-bits of |x|;
// kernel-domain words). The schedule is the Pallas kernel's
// (ops/pairing_program.py): affine conversion; 63 Miller steps of a complex
// squaring and 13-product sparse lines, the addition lines only on the
// one-bits; the easy part; five exp-by-x chains of Granger-Scott cyclotomic
// squarings; a compare to 1. An identity input contributes the factor 1,
// and a row of two identities is true at once.
//
// Bound: integer multiply throughput. About 17,000 Fp products per row with
// two non-identity points, each a CIOS product of 300 32x32 word multiplies
// (chip_smoke.py counts them with the Pallas kernel's algorithm). One thread
// per row made the time one thread's chain of all of them (~54,000 with a
// schoolbook tower). Here the time is a row's critical path: ~3,300 stages.
//
// Design: a group of G lanes (32 by default, or 16) per row. Every
// tower formula is a stack of independent Fp products, so the host traces
// each step of the schedule (ops/tower.py's k12_* functions, run on a
// symbolic field) into a program: stages of products, of linear
// combinations (the Pallas kernel's adds and subtracts, a node used once
// folded into its user) or of inversions. A stage's items are spread over
// the group's lanes; a lane builds each operand as an integer combination
// of slots (PTX carry chains, reduced once per add), runs its two products
// of the stage interleaved in registers, and writes them to slots. A slot
// is one Fp (12 words) in the row's slice of shared memory; stages are
// separated by __syncwarp on the group's mask, with no block barrier after
// the block's loads. Inversions run the binary extended Euclidean
// algorithm on one lane each (the two affine ones at once), a few percent
// of a Fermat ladder's products. A block loads the ladders and the loops'
// programs (the head of the int32 program table) into shared memory once;
// the other programs and the constants (one, the Frobenius gammas) are
// read from global memory. Rows per block fill the SMs once at the batch's
// size (cuda_pairing.rows_per_block). The 63-step loops stay rolled, so
// nvcc builds this file in seconds.
#include "field.cuh"

constexpr int SLOT_WORDS = 12;
constexpr int MILLER_STEPS = 63;
constexpr int LADDER_WORDS = 2 * PAIR_LINE_PAIR_STRIDE * SLOT_WORDS;

DEV void load_slot(uint32_t* r, const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 3; k++) {
    const uint4 v = q[k];
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

DEV void store_slot(uint32_t* p, const uint32_t* r) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < 3; k++) q[k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

// One program run: the bases a slot reference names, and the row's group.
struct Run {
  const int* tab_hot;  // the head of the program table (shared): the HOT programs
  const int* tab_all;  // the whole table (global)
  int hot_words;
  const uint32_t* consts;
  const uint32_t* line;      // this Miller step's doubling lines (shared)
  const uint32_t* line_add;  // this one-bit's addition lines (shared)
  uint32_t* row;         // the row's slots (shared)
  uint32_t* a0;
  uint32_t* a1;
  uint32_t* a2;
  int lane, G;
  unsigned mask;
  long long* prof;  // optional: cycles in product, linear and inversion stages, and the stage count
};

// The slot-reference bases of one program run, in registers.
struct Bases {
  const uint32_t *a0, *a1, *a2, *stage, *scratch, *consts, *line, *line_add;
};

DEV const uint32_t* slot_ptr(const Bases& b, int ref) {
  const int off = (ref & 0xfff) * SLOT_WORDS;
  switch ((ref >> 12) & 0xf) {
    case PAIR_ARG0: return b.a0 + off;
    case PAIR_ARG1: return b.a1 + off;
    case PAIR_ARG2: return b.a2 + off;
    case PAIR_STAGE: return b.stage + off;
    case PAIR_SCRATCH: return b.scratch + off;
    case PAIR_CONST: return b.consts + off;
    case PAIR_LINE: return b.line + off;
    default: return b.line_add + off;
  }
}

// Carry-chain word arithmetic (the PTX carry flag, one instruction a word).
DEV uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
DEV uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
DEV uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
DEV uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
DEV uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// r = a + b mod p for a, b <= p (a + b < 2^384): the sum, then p subtracted
// unless that borrows
DEV void cc_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[12], d[12];
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) t[i] = addc_cc(a[i], b[i]);
  d[0] = sub_cc(t[0], FpT::mod(0));
#pragma unroll
  for (int i = 1; i < 12; i++) d[i] = subc_cc(t[i], FpT::mod(i));
  const uint32_t borrow = subc(0u, 0u);  // all ones when t < p
#pragma unroll
  for (int i = 0; i < 12; i++) r[i] = borrow ? t[i] : d[i];
}

// r = p - a for a <= p (p for a = 0, which cc_add accepts)
DEV void cc_neg(uint32_t* r, const uint32_t* a) {
  r[0] = sub_cc(FpT::mod(0), a[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) r[i] = subc_cc(FpT::mod(i), a[i]);
}

// acc = the integer combination of slots at tab[at] ([n, terms...]), mod p;
// returns the index past it. A negative coefficient adds |c| (p - x); p - 0
// = p is left only by a lone negated term, which a last add of 0 reduces.
DEV int combo(uint32_t* acc, const Bases& b, const int* tab, int at) {
  const int n = tab[at];
  bool reduced = true;
  f_zero<FpT>(acc);
#pragma unroll 1
  for (int k = 0; k < n; k++) {
    const int t = tab[at + 1 + k];
    const int coef = (int)(int8_t)((t >> 16) & 0xff);
    uint32_t v[SLOT_WORDS];
    load_slot(v, slot_ptr(b, t));
    if (coef < 0) cc_neg(v, v);
    int c = coef < 0 ? -coef : coef;
    if (k == 0) {
      f_copy<FpT>(acc, v);
      c -= 1;
      reduced = coef > 0;
    }
#pragma unroll 1
    for (; c > 0; c--) {
      cc_add(acc, acc, v);
      reduced = true;
    }
  }
  if (!reduced) {
    uint32_t z[SLOT_WORDS];
    f_zero<FpT>(z);
    cc_add(acc, acc, z);
  }
  return at + 1 + n;
}

DEV void shr1(uint32_t* x) {
#pragma unroll
  for (int i = 0; i < 11; i++) x[i] = (x[i] >> 1) | (x[i + 1] << 31);
  x[11] >>= 1;
}

// x / 2 mod p for x < p: (x + p) / 2 when x is odd (x + p < 2^384)
DEV void half_mod(uint32_t* x) {
  const uint32_t m = (x[0] & 1) ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    c += (uint64_t)x[i] + (FpT::mod(i) & m);
    x[i] = (uint32_t)c;
    c >>= 32;
  }
  shr1(x);
}

DEV bool is_one_plain(const uint32_t* x) {
  uint32_t acc = x[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < 12; i++) acc |= x[i];
  return acc == 0;
}

// x^-1 by the binary extended Euclidean algorithm (0 maps to 0): u = x1 x
// and v = x2 x (mod p) throughout, so u = 1 leaves x1 = x^-1 = a^-1 R^-1 for
// x = a R; a Montgomery product with R^3 mod p makes it a^-1 R. Its
// ~1,100 steps of shifts and subtractions cost a few percent of the ~490
// Montgomery products of the Fermat ladder.
DEV_NOINLINE void gcd_inv(uint32_t* r, const uint32_t* x) {
  if (f_is_zero<FpT>(x)) {
    f_zero<FpT>(r);
    return;
  }
  uint32_t u[12], v[12], x1[12], x2[12];
#pragma unroll
  for (int i = 0; i < 12; i++) {
    u[i] = x[i];
    v[i] = FpT::mod(i);
    x1[i] = i == 0;
    x2[i] = 0;
  }
#pragma unroll 1
  while (!is_one_plain(u) && !is_one_plain(v)) {
#pragma unroll 1
    while (!(u[0] & 1)) {
      shr1(u);
      half_mod(x1);
    }
#pragma unroll 1
    while (!(v[0] & 1)) {
      shr1(v);
      half_mod(x2);
    }
    uint32_t d[12];
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
      const uint64_t t = (uint64_t)u[i] - v[i] - br;
      d[i] = (uint32_t)t;
      br = t >> 63;
    }
    if (!br) {  // u >= v
      f_copy<FpT>(u, d);
      f_sub<FpT>(x1, x1, x2);
    } else {
      br = 0;
#pragma unroll
      for (int i = 0; i < 12; i++) {
        const uint64_t t = (uint64_t)v[i] - u[i] - br;
        v[i] = (uint32_t)t;
        br = t >> 63;
      }
      f_sub<FpT>(x2, x2, x1);
    }
  }
  uint32_t r3[12];
#pragma unroll
  for (int i = 0; i < 12; i++) r3[i] = FP_R3[i];
  f_mul<FpT>(r, is_one_plain(u) ? x1 : x2, r3);
}

// Run program `pid` (ops/pairing_program.py): its stages' items spread over
// the group's lanes, then the staged outputs copied to dst. A stage holds
// items of one kind. In a product stage every lane runs two products at
// once, items i and i + G (zeros where it has none), so that the group
// stays converged.
DEV_NOINLINE void run_program(const Run& r, int pid, uint32_t* dst) {
  const Bases b{r.a0, r.a1, r.a2, r.row + PAIR_ROW_STAGE * SLOT_WORDS, r.row + PAIR_ROW_SCRATCH * SLOT_WORDS,
                r.consts, r.line, r.line_add};
  const int head = r.tab_hot[pid];
  const int* tab = head < r.hot_words ? r.tab_hot : r.tab_all;
  const int n_stages = tab[head], n_out = tab[head + 1];
#pragma unroll 1
  for (int s = 0; s < n_stages; s++) {
    const int st = tab[head + 2 + s];
    const int n = tab[st];
    const int kind = tab[st + 1];
    const long long t0 = r.prof ? clock64() : 0;
    if (kind == PAIR_PROD) {
#pragma unroll 1
      for (int i = r.lane; i - r.lane < n; i += 2 * r.G) {
        const int j = i + r.G;
        uint32_t a0[SLOT_WORDS], b0[SLOT_WORDS], a1[SLOT_WORDS], b1[SLOT_WORDS];
        int d0 = -1, d1 = -1;
        if (i < n) {
          const int at = tab[st + 2 + i];
          d0 = tab[at + 1];
          combo(b0, b, tab, combo(a0, b, tab, at + 2));
        } else {
          f_zero<FpT>(a0);
          f_zero<FpT>(b0);
        }
        if (j < n) {
          const int at = tab[st + 2 + j];
          d1 = tab[at + 1];
          combo(b1, b, tab, combo(a1, b, tab, at + 2));
        } else {
          f_zero<FpT>(a1);
          f_zero<FpT>(b1);
        }
        f_mul2<FpT>(a0, a0, b0, a1, a1, b1);
        if (d0 >= 0) store_slot(const_cast<uint32_t*>(slot_ptr(b, d0)), a0);
        if (d1 >= 0) store_slot(const_cast<uint32_t*>(slot_ptr(b, d1)), a1);
      }
    } else {
#pragma unroll 1
      for (int i = r.lane; i < n; i += r.G) {
        const int at = tab[st + 2 + i];
        uint32_t a[SLOT_WORDS], out[SLOT_WORDS];
        combo(a, b, tab, at + 2);
        if (kind == PAIR_INV)
          gcd_inv(out, a);
        else
          f_copy<FpT>(out, a);
        store_slot(const_cast<uint32_t*>(slot_ptr(b, tab[at + 1])), out);
      }
    }
    __syncwarp(r.mask);
    if (r.prof) {
      r.prof[kind == PAIR_PROD ? 0 : kind == PAIR_LIN ? 1 : 2] += clock64() - t0;
      r.prof[3] += 1;
    }
  }
  if (dst != nullptr) {
    const uint32_t* src = r.row + PAIR_ROW_STAGE * SLOT_WORDS;
#pragma unroll 1
    for (int w = r.lane; w < n_out * SLOT_WORDS; w += r.G) dst[w] = src[w];
    __syncwarp(r.mask);
  }
}

template <int G>
__global__ void pairing_kernel(const int64_t* el, const int64_t* er, const uint32_t* lines, const int* tab,
                               const uint32_t* consts, int* out, long long* phases, const int* enable, int B,
                               int row_slots, int hot_words) {
  // enable (optional, one word on the device): 0 gates the whole call off,
  // as lax.cond around the JAX package's pairing program; every block then
  // writes true for its rows and leaves before any barrier
  if (enable != nullptr && __ldg(enable) == 0) {
    const int rows = blockDim.x / G;
    for (int k = threadIdx.x; k < rows; k += blockDim.x) {
      const int b = blockIdx.x * rows + k;
      if (b < B) out[b] = 1;
    }
    return;
  }
  // shared memory: the ladders, the head of the program table (rounded up
  // to 4 words), then each row's slots
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ladder = smem;
  int* tab_hot = reinterpret_cast<int*>(smem + LADDER_WORDS);
  const int hot_pad = (hot_words + 3) & ~3;
  for (int k = threadIdx.x; k < LADDER_WORDS / 4; k += blockDim.x)
    reinterpret_cast<uint4*>(ladder)[k] = __ldg(reinterpret_cast<const uint4*>(lines) + k);
  for (int k = threadIdx.x; k < hot_words; k += blockDim.x) tab_hot[k] = __ldg(tab + k);
  __syncthreads();
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * (blockDim.x / G) + group;
  if (b >= B) return;  // the whole group leaves; no block barrier follows

  Run r;
  r.tab_hot = tab_hot;
  r.tab_all = tab;
  r.hot_words = hot_words;
  r.consts = consts;
  r.line = r.line_add = ladder;
  r.row = smem + LADDER_WORDS + hot_pad + (size_t)group * row_slots * SLOT_WORDS;
  r.lane = lane;
  r.G = G;
  r.mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  uint32_t* row = r.row;
  auto slot = [&](int k) { return row + k * SLOT_WORDS; };

  // the six coordinates X0 X1 Y0 Y1 Z0 Z1, into the kernel's domain
  if (lane < 6) {
    const int c = lane >> 1;
    const int64_t* src = ((lane & 1) ? er : el) + (size_t)b * 75 + c * 25;
    uint32_t v[SLOT_WORDS];
    load_port<FpT>(v, src);
    store_slot(slot(PAIR_ROW_RAW + lane), v);
  }
  __syncwarp(r.mask);
  const int live = (f_is_zero<FpT>(slot(PAIR_ROW_RAW + 4)) ? 0 : 1) | (f_is_zero<FpT>(slot(PAIR_ROW_RAW + 5)) ? 0 : 2);
  if (live == 0) {  // e(O, Q1) e(O, Q2) = 1
    if (lane == 0) out[b] = 1;
    return;
  }
  // phases (optional, (B, 10)): clock64() at the start and after the affine
  // conversion, the Miller loop, the easy part, the five chains, the tail;
  // then the cycles spent in product, linear and inversion stages, and the
  // number of stages run
  long long* ph = (phases != nullptr && lane == 0) ? phases + (size_t)b * 10 : nullptr;
  long long prof[4] = {0, 0, 0, 0};
  r.prof = ph ? prof : nullptr;
  if (ph) ph[0] = clock64();
  r.a0 = slot(PAIR_ROW_RAW);
  run_program(r, PAIR_PROG_AFFINE, slot(PAIR_ROW_PTS));
  if (ph) ph[1] = clock64();

#pragma unroll 1
  for (int k = lane; k < 12; k += G) {  // f = 1
    uint32_t v[SLOT_WORDS];
    if (k == 0)
      f_one<FpT>(v);
    else
      f_zero<FpT>(v);
    store_slot(slot(PAIR_ROW_F + k), v);
  }
  __syncwarp(r.mask);
  r.a0 = slot(PAIR_ROW_F);
  r.a1 = slot(PAIR_ROW_PTS);
  int n_add = 0;
#pragma unroll 1
  for (int i = 0; i < MILLER_STEPS; i++) {
    const int bit = (int)((BLS_X_ABS >> (62 - i)) & 1);
    r.line = ladder + i * 4 * SLOT_WORDS;
    r.line_add = ladder + (MILLER_STEPS + n_add) * 4 * SLOT_WORDS;
    run_program(r, PAIR_PROG_MILLER + 3 * bit + live - 1, slot(PAIR_ROW_F));
    n_add += bit;
  }

  if (ph) ph[2] = clock64();
  // final exponentiation: the easy part into m, then five exp-by-x chains
  run_program(r, PAIR_PROG_EASY, slot(PAIR_ROW_M));
  if (ph) ph[3] = clock64();
  uint32_t* cur = slot(PAIR_ROW_M);
#pragma unroll 1
  for (int step = 0; step < 5; step++) {
    r.a0 = cur;
    r.a1 = cur;
#pragma unroll 1
    for (int i = 0; i < MILLER_STEPS; i++) {
      run_program(r, PAIR_PROG_CYC + (int)((BLS_X_ABS >> (62 - i)) & 1), slot(PAIR_ROW_ACC));
      r.a0 = slot(PAIR_ROW_ACC);
    }
    uint32_t* dst = slot(step == 2 ? PAIR_ROW_CS : PAIR_ROW_CUR);  // m stays for the tail, c after step 2
    run_program(r, PAIR_PROG_COMBINE + (step < 2 ? 0 : step == 2 ? 1 : 2), dst);
    cur = dst;
  }
  if (ph) ph[4] = clock64();
  r.a0 = slot(PAIR_ROW_M);
  run_program(r, PAIR_PROG_CUBE, slot(PAIR_ROW_F));  // m^3 where f was
  r.a0 = cur;
  r.a1 = slot(PAIR_ROW_CS);
  r.a2 = slot(PAIR_ROW_F);
  run_program(r, PAIR_PROG_TAIL, slot(PAIR_ROW_ACC));
  if (lane == 0) {
    uint32_t one[SLOT_WORDS];
    f_one<FpT>(one);
    bool ok = f_eq<FpT>(slot(PAIR_ROW_ACC), one);
#pragma unroll 1
    for (int k = 1; k < 12; k++) ok = ok && f_is_zero<FpT>(slot(PAIR_ROW_ACC + k));
    out[b] = ok ? 1 : 0;
    if (ph) {
      ph[5] = clock64();
      for (int k = 0; k < 4; k++) ph[6 + k] = prof[k];
    }
  }
}

template <int G>
static int launch(const int64_t* el, const int64_t* er, const uint32_t* lines, const int* tab,
                  const uint32_t* consts, int* out, long long* phases, const int* enable, int B, int rows,
                  int row_slots, int hot_words, cudaStream_t stream) {
  const size_t smem =
      sizeof(uint32_t) * (LADDER_WORDS + ((hot_words + 3) & ~3) + (size_t)rows * row_slots * SLOT_WORDS);
  cudaError_t e = cudaFuncSetAttribute(pairing_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pairing_kernel<G><<<(B + rows - 1) / rows, rows * G, smem, stream>>>(el, er, lines, tab, consts, out, phases, enable,
                                                                          B, row_slots, hot_words);
  return (int)cudaGetLastError();
}

extern "C" int ph2_pairing_check(const int64_t* el, const int64_t* er, const uint32_t* lines, const int* tab,
                                 const uint32_t* consts, int* out, long long* phases, const int* enable, int B,
                                 int lanes, int rows, int row_slots, int hot_words, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 16: return launch<16>(el, er, lines, tab, consts, out, phases, enable, B, rows, row_slots, hot_words, s);
    case 32: return launch<32>(el, er, lines, tab, consts, out, phases, enable, B, rows, row_slots, hot_words, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
