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
// Bound: a row's critical path. About 17,000 Fp products per row with two
// non-identity points, each a CIOS product of 300 32x32 word multiplies
// (chip_smoke.py counts them with the Pallas kernel's algorithm), spread
// over the stages of a program: 3,345 dependent stages a row, 560 of them
// product passes, the rest linear combinations and three inversions. At
// 128 rows (one row an SM) or 1,024 (eight) the card holds too few rows to
// hide a row's latency, so the time is one row's chain of stages, not the
// card's multiply throughput. On an H100 with one warp an SM a pass of
// f_mul2 takes ~5,900 cycles and f_mul ~2,600. Built term by term (a table
// read, a switch over eight slot bases, three shared loads, a negation and
// a modular add, a conditional subtract of p after every add), the operands
// took most of a row's ~13.6e6 cycles (linear stages 6.5e6, product stages
// 5.1e6 with their operands, inversions 0.6e6); with the operand path below
// a row takes ~8.4e6 (linear 2.8e6, product stages 4.2e6, ~3.3e6 of that
// f_mul2, inversions 0.6e6), so the products now lead.
//
// Design: a group of G lanes (32 by default, or 16) per row. Every tower
// formula is a stack of independent Fp products, so the host traces each
// step of the schedule (ops/tower.py's k12_* functions, run on a symbolic
// field) into a program: stages of products, of linear combinations (the
// Pallas kernel's adds and subtracts, a node used once folded into its
// user) or of inversions. A stage's items are spread over the group's lanes;
// a lane builds each operand as an integer combination of slots, runs its
// two products of the stage interleaved in registers (f_mul2), and writes
// them to slots. A slot is one Fp (12 words) in the row's slice of shared
// memory; stages are separated by __syncwarp on the group's mask, with no
// block barrier after the block's loads. Inversions run the binary
// extended Euclidean algorithm on one lane each (the two affine ones at
// once), a few percent of a Fermat ladder's products. A block copies the
// ladders, the int32 program table and each row's constants into shared
// memory once, all in flight together (cp.async). Rows per block fill the
// SMs once at the batch's size (cuda_pairing.rows_per_block). The 63-step
// loops stay rolled, so nvcc builds this file in seconds.
//
// The operand path. Every term of the table is resolved on the host to one
// word offset in the row's slice and a small signed coefficient: a row
// holds its own copy of the constants (one, the Frobenius gammas) and of
// the Miller step's lines (copied in from the block's ladder at each step),
// and a chain's cur is copied into fixed slots before its steps, so a term
// costs one add to the row's base. A stage's header carries its largest
// combination K (rounded up to PAIR_PAD), and every combination of the
// stage has K terms (zero-coefficient terms pad it). A lane evaluates the
// combinations of its items together, PAIR_PAD terms at a time: their
// descriptors, then all their slot loads, then the sums, each term added
// as |c| (x XOR sign) into 64-bit word accumulators with no carry between
// words (a negative term adds |c| (2^384 - 1 - x) and is corrected once).
// One reduction closes a combination: with COMBO_M p added, the sum W lies
// in [p, 17 p); a quotient q from the top word is floor(W / p) or one less,
// so W - q p and W - (q + 1) p, two carry chains that run side by side,
// leave the fully reduced value word for word (the one whose top bit is
// clear). A deeper load-ahead (4 terms) was no faster at 64, 128 or 1,024
// rows, and holding a product stage's four combinations at once ran out of
// registers; a product pass builds its two items' operands one item after
// the other.
#include "field.cuh"

constexpr int SLOT_WORDS = 12;
constexpr int MILLER_STEPS = 63;
constexpr int LADDER_WORDS = 2 * PAIR_LINE_PAIR_STRIDE * SLOT_WORDS;

// the block's shared memory: the ladders, the program table (rounded up to 4
// words), then each row's slots; every table read and slot access below
// indexes it, so all of them are shared-memory instructions
extern __shared__ __align__(16) uint32_t smem[];

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

// n 16-byte words from global src to shared dst, spread over `threads`
// threads from `t`, all in flight at once (cp.async); the caller waits
// (async_wait) and then synchronizes
DEV void async_copy(uint32_t* dst, const void* src, int n, int t, int threads) {
#pragma unroll 1
  for (int k = t; k < n; k += threads) {
#ifdef PH2_CPU_SIM
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
#else
    const unsigned s = (unsigned)__cvta_generic_to_shared(reinterpret_cast<uint4*>(dst) + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(reinterpret_cast<const uint4*>(src) + k)
                 : "memory");
#endif
  }
}

DEV void async_wait() {
#ifndef PH2_CPU_SIM
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// n slots from src to dst, spread over the group's lanes (16-byte copies)
DEV void copy_slots(uint32_t* dst, const uint32_t* src, int n, int lane, int G) {
#pragma unroll 1
  for (int k = lane; k < 3 * n; k += G) reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
}

// One program run: where the table and the row's slots start in smem, and
// the row's group.
struct Run {
  int tab_off, row_off;
  int lane, G;
  unsigned mask;
  long long* prof;  // optional: cycles in product, linear and inversion stages, and the stage count
};

// Terms k.. k + PAIR_PAD - 1 of NC combinations (desc[c]: combination c's
// terms) into their accumulators: the descriptors, then every slot load,
// then the sums
template <int NC>
DEV void gather(uint64_t (&acc)[NC][SLOT_WORDS], uint32_t (&cn)[NC], const uint32_t* row,
                const int* const (&desc)[NC], int k) {
  constexpr int D = PAIR_PAD;
  int t[NC][D];
  uint32_t v[NC][D][SLOT_WORDS];
#pragma unroll
  for (int c = 0; c < NC; c++)
#pragma unroll
    for (int d = 0; d < D; d++) t[c][d] = desc[c][k + d];
#pragma unroll
  for (int c = 0; c < NC; c++)
#pragma unroll
    for (int d = 0; d < D; d++) load_slot(v[c][d], row + (t[c][d] >> 8));
#pragma unroll
  for (int c = 0; c < NC; c++)
#pragma unroll
    for (int d = 0; d < D; d++) {
      const int coef = (int)(int8_t)(t[c][d] & 0xff);
      const uint32_t neg = coef < 0 ? 0xffffffffu : 0u;
      const uint32_t m = (uint32_t)(coef < 0 ? -coef : coef);
      cn[c] += neg & m;
#pragma unroll
      for (int i = 0; i < SLOT_WORDS; i++) acc[c][i] += (uint64_t)m * (v[c][d][i] ^ neg);
    }
}

// r = sum_i (l_i + h_i 2^32) 2^(32 i) mod 2^384: r_0 = l_0, then one carry
// chain (the PTX carry flag, one instruction a word)
DEV void fold_words(uint32_t* r, const uint32_t* l, const uint32_t* h) {
  r[0] = l[0];
#ifdef PH2_CPU_SIM
  uint64_t c = 0;
  for (int i = 1; i < 12; i++) {
    c += (uint64_t)l[i] + h[i - 1];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
#else
#pragma unroll
  for (int i = 1; i < 12; i++) r[i] = l[i];
  asm("add.cc.u32 %0, %0, %11;\n\t"
      "addc.cc.u32 %1, %1, %12;\n\t"
      "addc.cc.u32 %2, %2, %13;\n\t"
      "addc.cc.u32 %3, %3, %14;\n\t"
      "addc.cc.u32 %4, %4, %15;\n\t"
      "addc.cc.u32 %5, %5, %16;\n\t"
      "addc.cc.u32 %6, %6, %17;\n\t"
      "addc.cc.u32 %7, %7, %18;\n\t"
      "addc.cc.u32 %8, %8, %19;\n\t"
      "addc.cc.u32 %9, %9, %20;\n\t"
      "addc.u32 %10, %10, %21;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]), "+r"(r[11])
      : "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]), "r"(h[4]), "r"(h[5]), "r"(h[6]), "r"(h[7]), "r"(h[8]),
        "r"(h[9]), "r"(h[10]));
#endif
}

// r = W mod p, fully reduced, for the accumulated combination: W = acc +
// cn - cn 2^384 (the negative terms' correction; acc holds COMBO_M p) lies
// in [p, 17 p). q = floor((acc_11 - cn 2^32) / 2^8 / ((p >> 360) + 1)) is
// floor(W / p) or one less, so W - q p lies in [0, 2 p); both W - q p and
// W - (q + 1) p are taken mod 2^384 as acc + cn + q' (2^384 - p), and the
// second, unless it wrapped (top bit set), is the value.
DEV void reduce_combo(uint32_t* r, const uint64_t* acc, uint32_t cn) {
  const uint64_t top = acc[11] - ((uint64_t)cn << 32);
  const uint32_t q = (uint32_t)(top >> 8) / PAIR_QDIV;
  uint32_t l0[SLOT_WORDS], h0[SLOT_WORDS], l1[SLOT_WORDS], h1[SLOT_WORDS];
#pragma unroll
  for (int i = 0; i < SLOT_WORDS; i++) {
    const uint64_t base = acc[i] + (i == 0 ? cn : 0u);
    const uint64_t a = base + (uint64_t)q * PAIR_NEGP[i];
    const uint64_t b = base + (uint64_t)(q + 1) * PAIR_NEGP[i];
    l0[i] = (uint32_t)a;
    h0[i] = (uint32_t)(a >> 32);
    l1[i] = (uint32_t)b;
    h1[i] = (uint32_t)(b >> 32);
  }
  uint32_t r0[SLOT_WORDS], r1[SLOT_WORDS];
  fold_words(r0, l0, h0);
  fold_words(r1, l1, h1);
  const bool wrapped = (r1[11] >> 31) != 0;
#pragma unroll
  for (int i = 0; i < SLOT_WORDS; i++) r[i] = wrapped ? r0[i] : r1[i];
}

// NC combinations of K terms each (desc[c]: combination c's terms; K a
// multiple of PAIR_PAD), fully reduced into out[c]: PAIR_PAD terms at a time
template <int NC>
DEV void combos(uint32_t (*out)[SLOT_WORDS], const uint32_t* row, const int* const (&desc)[NC], int K) {
  uint64_t acc[NC][SLOT_WORDS];
  uint32_t cn[NC];
#pragma unroll
  for (int c = 0; c < NC; c++) {
    cn[c] = 0;
#pragma unroll
    for (int i = 0; i < SLOT_WORDS; i++) acc[c][i] = PAIR_COMBO_MP[i];
  }
#pragma unroll 1
  for (int k = 0; k < K; k += PAIR_PAD) gather<NC>(acc, cn, row, desc, k);
#pragma unroll
  for (int c = 0; c < NC; c++) reduce_combo(out[c], acc[c], cn[c]);
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
// once, items i and i + G (zeros where the stage fits one pass of single
// items); a linear stage gives a lane one item, or two at once where its
// items outnumber the lanes. A lane past the stage's items repeats an item
// and stores nothing, so that the group stays converged.
DEV_NOINLINE void run_program(const Run r, int pid, uint32_t* dst) {
  const int* tab = reinterpret_cast<const int*>(smem + r.tab_off);
  uint32_t* row = smem + r.row_off;
  const int head = tab[pid];
  const int n_stages = tab[head], n_out = tab[head + 1];
  const int lane = r.lane, G = r.G;
  int at = head + 2;
  int hdr = tab[at];
  long long cyc_prod = 0, cyc_lin = 0, cyc_inv = 0;
#pragma unroll 1
  for (int s = 0; s < n_stages; s++) {
    const int n = hdr & 0xff, kind = (hdr >> 8) & 3, K = hdr >> 10;
    const int* items = tab + at + 1;
    const int stride = 1 + (kind == PAIR_PROD ? 2 : 1) * K;
    const int next = at + 1 + n * stride;
    const long long t0 = r.prof ? clock64() : 0;
    if (kind == PAIR_PROD) {
#pragma unroll 1
      for (int i = lane; i - lane < n; i += 2 * G) {
        const int j = i + G;
        const int* ia = items + min(i, n - 1) * stride;
        const int* ib = items + (j < n ? j : min(i, n - 1)) * stride;
        uint32_t o[4][SLOT_WORDS];
        const int* const da[2] = {ia + 1, ia + 1 + K};
        combos<2>(o, row, da, K);
        if (n > G) {
          const int* const db[2] = {ib + 1, ib + 1 + K};
          combos<2>(o + 2, row, db, K);
        } else {
          f_zero<FpT>(o[2]);
          f_zero<FpT>(o[3]);
        }
        f_mul2<FpT>(o[0], o[0], o[1], o[2], o[2], o[3]);
        if (i < n) store_slot(row + ia[0], o[0]);
        if (j < n) store_slot(row + ib[0], o[2]);
      }
    } else if (n > G) {
#pragma unroll 1
      for (int i = lane; i - lane < n; i += 2 * G) {
        const int j = i + G;
        const int* ia = items + min(i, n - 1) * stride;
        const int* ib = items + (j < n ? j : min(i, n - 1)) * stride;
        uint32_t o[2][SLOT_WORDS];
        const int* const desc[2] = {ia + 1, ib + 1};
        combos<2>(o, row, desc, K);
        if (i < n) store_slot(row + ia[0], o[0]);
        if (j < n) store_slot(row + ib[0], o[1]);
      }
    } else if (lane < n) {
      const int* ia = items + lane * stride;
      uint32_t o[1][SLOT_WORDS];
      const int* const desc[1] = {ia + 1};
      combos<1>(o, row, desc, K);
      if (kind == PAIR_INV) {
        uint32_t x[SLOT_WORDS], v[SLOT_WORDS];  // only these pass through memory to gcd_inv
        f_copy<FpT>(x, o[0]);
        gcd_inv(v, x);
        store_slot(row + ia[0], v);
      } else {
        store_slot(row + ia[0], o[0]);
      }
    }
    if (s + 1 < n_stages) hdr = tab[next];  // the next stage's header, before the barrier
    __syncwarp(r.mask);
    if (r.prof) {
      const long long t = clock64() - t0;
      if (kind == PAIR_PROD)
        cyc_prod += t;
      else if (kind == PAIR_LIN)
        cyc_lin += t;
      else
        cyc_inv += t;
    }
    at = next;
  }
  if (r.prof) {
    r.prof[0] += cyc_prod;
    r.prof[1] += cyc_lin;
    r.prof[2] += cyc_inv;
    r.prof[3] += n_stages;
  }
  if (dst != nullptr) {
    copy_slots(dst, row + PAIR_ROW_STAGE * SLOT_WORDS, n_out, lane, G);
    __syncwarp(r.mask);
  }
}

// One row from its affine conversion on (the raw coordinates and the
// constants are in its slots): the Miller loop, the final exponentiation,
// the compare to 1 into *out
DEV void pairing_row(Run& r, const uint32_t* ladder, int live, int* out, long long* ph) {
  uint32_t* row = smem + r.row_off;
  const int lane = r.lane, G = r.G;
  auto slot = [&](int k) { return row + k * SLOT_WORDS; };
  long long prof[4] = {0, 0, 0, 0};
  r.prof = ph ? prof : nullptr;
  if (ph) ph[0] = clock64();
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
  int n_add = 0;
#pragma unroll 1
  for (int i = 0; i < MILLER_STEPS; i++) {
    const int bit = (int)((BLS_X_ABS >> (62 - i)) & 1);
    // this step's lines into the row: per pair its doubling line's 4 slots
    // (12 16-byte words), on a one-bit its addition line's too
#pragma unroll 1
    for (int k = lane; k < (bit ? 48 : 24); k += G) {
      const int set = k / 24, j = (k % 24) / 12, w = k % 12;
      const int line = set ? MILLER_STEPS + n_add : i;
      reinterpret_cast<uint4*>(slot((set ? PAIR_ROW_LINE_ADD : PAIR_ROW_LINE) + 4 * j))[w] =
          reinterpret_cast<const uint4*>(ladder + (j * PAIR_LINE_PAIR_STRIDE + 4 * line) * SLOT_WORDS)[w];
    }
    __syncwarp(r.mask);
    run_program(r, PAIR_PROG_MILLER + 3 * bit + live - 1, slot(PAIR_ROW_F));
    n_add += bit;
  }

  if (ph) ph[2] = clock64();
  // final exponentiation: the easy part into m, then five exp-by-x chains,
  // each on its cur copied into ROW_CUR and ROW_ACC
  run_program(r, PAIR_PROG_EASY, slot(PAIR_ROW_M));
  if (ph) ph[3] = clock64();
  uint32_t* cur = slot(PAIR_ROW_M);
#pragma unroll 1
  for (int step = 0; step < 5; step++) {
    if (cur != slot(PAIR_ROW_CUR)) copy_slots(slot(PAIR_ROW_CUR), cur, 12, lane, G);
    copy_slots(slot(PAIR_ROW_ACC), cur, 12, lane, G);
    __syncwarp(r.mask);
#pragma unroll 1
    for (int i = 0; i < MILLER_STEPS; i++)
      run_program(r, PAIR_PROG_CYC + (int)((BLS_X_ABS >> (62 - i)) & 1), slot(PAIR_ROW_ACC));
    cur = slot(step == 2 ? PAIR_ROW_CS : PAIR_ROW_CUR);  // m stays for the tail, c after step 2
    run_program(r, PAIR_PROG_COMBINE + (step < 2 ? 0 : step == 2 ? 1 : 2), cur);
  }
  if (ph) ph[4] = clock64();
  run_program(r, PAIR_PROG_CUBE, slot(PAIR_ROW_F));  // m^3 where f was
  run_program(r, PAIR_PROG_TAIL, slot(PAIR_ROW_ACC));
  if (lane == 0) {
    uint32_t one[SLOT_WORDS];
    f_one<FpT>(one);
    bool ok = f_eq<FpT>(slot(PAIR_ROW_ACC), one);
#pragma unroll 1
    for (int k = 1; k < 12; k++) ok = ok && f_is_zero<FpT>(slot(PAIR_ROW_ACC + k));
    *out = ok ? 1 : 0;
    if (ph) {
      ph[5] = clock64();
      for (int k = 0; k < 4; k++) ph[6 + k] = prof[k];
    }
  }
}

template <int G>
__global__ void pairing_kernel(const int64_t* el, const int64_t* er, const uint32_t* lines, const int* tab,
                               const uint32_t* consts, int* out, long long* phases, const int* enable, int B,
                               int row_slots, int tab_words) {
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
  uint32_t* ladder = smem;
  const int tab_pad = (tab_words + 3) & ~3;  // the table is padded to 4 words on the host
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * (blockDim.x / G) + group;
  const int row_off = LADDER_WORDS + tab_pad + group * row_slots * SLOT_WORDS;
  // the ladders, the table and each row's constants, copied in together
  async_copy(ladder, lines, LADDER_WORDS / 4, threadIdx.x, blockDim.x);
  async_copy(smem + LADDER_WORDS, tab, tab_pad / 4, threadIdx.x, blockDim.x);
  async_copy(smem + row_off + PAIR_ROW_CONST * SLOT_WORDS, consts, 3 * PAIR_N_CONST, lane, G);
  async_wait();
  __syncthreads();
  if (b >= B) return;  // the whole group leaves; no block barrier follows

  Run r;
  r.tab_off = LADDER_WORDS;
  r.row_off = row_off;
  r.lane = lane;
  r.G = G;
  r.mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  r.prof = nullptr;
  uint32_t* row = smem + r.row_off;
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
  pairing_row(r, ladder, live, out + b, ph);
}

template <int G>
static int launch(const int64_t* el, const int64_t* er, const uint32_t* lines, const int* tab,
                  const uint32_t* consts, int* out, long long* phases, const int* enable, int B, int rows,
                  int row_slots, int tab_words, cudaStream_t stream) {
  const size_t bytes =
      sizeof(uint32_t) * (LADDER_WORDS + ((tab_words + 3) & ~3) + (size_t)rows * row_slots * SLOT_WORDS);
  cudaError_t e = cudaFuncSetAttribute(pairing_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pairing_kernel<G><<<(B + rows - 1) / rows, rows * G, bytes, stream>>>(el, er, lines, tab, consts, out, phases, enable,
                                                                          B, row_slots, tab_words);
  return (int)cudaGetLastError();
}

extern "C" int ph2_pairing_check(const int64_t* el, const int64_t* er, const uint32_t* lines, const int* tab,
                                 const uint32_t* consts, int* out, long long* phases, const int* enable, int B,
                                 int lanes, int rows, int row_slots, int tab_words, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 16:
      return launch<16>(el, er, lines, tab, consts, out, phases, enable, B, rows, row_slots, tab_words, s);
    case 32:
      return launch<32>(el, er, lines, tab, consts, out, phases, enable, B, rows, row_slots, tab_words, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
