// Transcript kernel: replaces plutus_halo2_tpu/ops/pallas_blake.py:82
// (make_transcript_kernel, pallas_call at :245).
//
// What it computes: for every proof row, Blake2b-256 of every squeeze prefix
// buf[:len_s] of the row's transcript buffer (h1), and h2 = Blake2b-256(h1),
// as (B, S, 8) LE64 (lo, hi) words in int64. All full 128-byte blocks
// share one running chain; each squeeze adds one final-block compression
// (counter t = len_s bytes, final flag, bytes at or past len_s zero) and one
// 32-byte compression for h2.
//
// Bound: not a multiply kernel — 64-bit add/xor/rotate throughput. Per row
// with the simple_mul layout (9 squeezes, longest 1275 bytes): 9 chain +
// 9 final + 9 h2 = 27 compressions of 12 rounds x 8 G steps. A G is 22
// int32 operations: four 64-bit adds (two of them three-input) and four
// xors at 2 each, three rotations (24, 16, 63) at 2 funnel shifts each; the
// rotation by 32 swaps halves. The 9 chain blocks depend on each other, so
// a row's critical path is at least 9 + 1 + 1 = 11 compressions, far above
// the operations bound.
//
// Design (the Pallas kernel's three phases, on lane groups):
//  - A compression runs on L lanes (L = 4 or 1). The 4 x 4 state is held by
//    columns, as the Pallas kernel's quarters: lane l holds column l, the
//    words v[l], v[4+l], v[8+l], v[12+l] (L = 4), or one thread all four
//    (L = 1). A half-round is one G a column (_G4, pallas_blake.py:69); the
//    diagonal step (_rotq, :64) is three 64-bit __shfl_sync over the group
//    (L = 4) or a register permutation (L = 1). The message schedule is
//    static: each round's SIGMA row is spelled out, packed 4 bits an index.
//  - Every row of a block gets G groups. Phase 1: one group a row runs the
//    max_fb full blocks and stores the state after each block in shared
//    memory (the Pallas kernel's states_ref). Phase 2: the S final-block compressions, one a group, each resuming
//    from its squeeze's state; phase 3: the S h2 compressions on the same
//    groups. With G < S the squeezes take rounds. The critical path drops
//    from 2 S + max_fb compressions to max_fb + 2 (27 -> 11 for simple_mul).
//  - The block stages its rows' bytes once in shared memory (aligned
//    16-byte loads, neighbouring threads on neighbouring addresses), where
//    they read as LE64 words. Where the rows' bytes do not fit, even for
//    one row a block, nothing is staged (STAGED false): a group loads each
//    block it compresses from global memory into its message slot, and the
//    chain keeps only each squeeze's state, so that shared memory does not
//    grow with the transcript. A group's final
//    block is masked by words into its own 16-word message slot, which then
//    holds h1 for the h2 compression.
//  - Nothing takes a pointer to the state: the compression is inline and
//    fully unrolled, so state and message indices are static (no stack).
//  - Shuffles and __syncwarp name the whole warp: every lane of a warp runs
//    every phase (groups past the block's rows or squeezes compute on the
//    last one and store nothing); phase 1 is skipped only by whole warps.
#include <algorithm>

#include "lanes.cuh"  // FULL, the whole warp's mask

static __constant__ uint64_t B2_IV[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
    0x510e527fade682d1ull, 0x9b05688c2b3e6c1full, 0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
constexpr uint64_t B2_PARAM = 0x01010020ull;  // parameter block: digest 32 bytes, fanout 1, depth 1
constexpr int B2_WORDS = 16;                   // message words of a 128-byte block
constexpr int B2_MAX_THREADS = 512;            // a block's threads: 128 registers a thread

DEV uint64_t rotr64(uint64_t x, int r) { return (x >> r) | (x << (64 - r)); }

DEV void b2_g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t x, uint64_t y) {
  a = a + b + x;
  d = rotr64(d ^ a, 32);
  c = c + d;
  b = rotr64(b ^ c, 24);
  a = a + b + y;
  d = rotr64(d ^ a, 16);
  c = c + d;
  b = rotr64(b ^ c, 63);
}

// One compression's columns on this thread: Q = 4 / L of them, column
// l Q + j in slot j. iv_lo, iv_hi: B2_IV[col], B2_IV[4 + col].
template <int L>
struct B2Cols {
  static constexpr int Q = 4 / L;
  int l;
  uint64_t iv_lo[Q], iv_hi[Q];
  DEV explicit B2Cols(int lane) : l(lane) {
#pragma unroll
    for (int j = 0; j < Q; j++) {
      iv_lo[j] = B2_IV[col(j)];
      iv_hi[j] = B2_IV[4 + col(j)];
    }
  }
  DEV int col(int j) const { return l * Q + j; }
  // h0: the IV with the parameter block folded into word 0
  DEV void init(uint64_t (&ha)[Q], uint64_t (&hb)[Q]) const {
#pragma unroll
    for (int j = 0; j < Q; j++) {
      ha[j] = iv_lo[j] ^ (col(j) == 0 ? B2_PARAM : 0ull);
      hb[j] = iv_hi[j];
    }
  }
};

// Half a round, the column step or the diagonal step on rotated rows: the
// G of column `col` takes message words SIGMA[2 col], SIGMA[2 col + 1] of
// its half, packed 4 bits a column in px, py.
template <int L>
DEV void b2_half(const B2Cols<L>& k, uint64_t (&a)[4 / L], uint64_t (&b)[4 / L], uint64_t (&c)[4 / L],
                 uint64_t (&d)[4 / L], const uint64_t* m, uint32_t px, uint32_t py) {
#pragma unroll
  for (int j = 0; j < 4 / L; j++) {
    const int col = k.col(j);
    b2_g(a[j], b[j], c[j], d[j], m[(px >> (4 * col)) & 15], m[(py >> (4 * col)) & 15]);
  }
}

// Rotates the b, c, d rows by 1, 2, 3 columns (to the diagonal; back with
// BACK): column i takes column i + s of row b (s = 1, or 3 back), and so on.
template <int L, bool BACK>
DEV void b2_rotate(const B2Cols<L>& k, uint64_t (&b)[4 / L], uint64_t (&c)[4 / L], uint64_t (&d)[4 / L]) {
  constexpr int sb = BACK ? 3 : 1, sd = BACK ? 1 : 3;
  if constexpr (L == 4) {
    b[0] = __shfl_sync(FULL, b[0], (k.l + sb) & 3, 4);
    c[0] = __shfl_sync(FULL, c[0], (k.l + 2) & 3, 4);
    d[0] = __shfl_sync(FULL, d[0], (k.l + sd) & 3, 4);
  } else {
    const uint64_t b0[4] = {b[0], b[1], b[2], b[3]}, c0[4] = {c[0], c[1], c[2], c[3]},
                   d0[4] = {d[0], d[1], d[2], d[3]};
#pragma unroll
    for (int j = 0; j < 4; j++) {
      b[j] = b0[(j + sb) & 3];
      c[j] = c0[(j + 2) & 3];
      d[j] = d0[(j + sd) & 3];
    }
  }
}

#define B2_PK(a, b, c, d) ((uint32_t)(a) | (uint32_t)(b) << 4 | (uint32_t)(c) << 8 | (uint32_t)(d) << 12)
#define B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                              \
    b2_half<L>(k, a, b, c, d, m, B2_PK(s0, s2, s4, s6), B2_PK(s1, s3, s5, s7));     \
    b2_rotate<L, false>(k, b, c, d);                                                \
    b2_half<L>(k, a, b, c, d, m, B2_PK(s8, s10, s12, s14), B2_PK(s9, s11, s13, s15)); \
    b2_rotate<L, true>(k, b, c, d);                                                 \
  } while (0)

// One compression of the chain value (ha: words col, hb: words 4 + col)
// with the 16 message words m (shared memory), byte counter t, final flag.
template <int L>
DEV void b2_compress(const B2Cols<L>& k, uint64_t (&ha)[4 / L], uint64_t (&hb)[4 / L], const uint64_t* m,
                     uint64_t t, bool last) {
  constexpr int Q = 4 / L;
  uint64_t a[Q], b[Q], c[Q], d[Q];
#pragma unroll
  for (int j = 0; j < Q; j++) {
    a[j] = ha[j];
    b[j] = hb[j];
    c[j] = k.iv_lo[j];
    d[j] = k.iv_hi[j] ^ (k.col(j) == 0 ? t : 0ull) ^ (k.col(j) == 2 && last ? ~0ull : 0ull);
  }
  // 12 rounds, SIGMA[r % 10] spelled out
  B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  B2_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  B2_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  B2_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  B2_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  B2_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  B2_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  B2_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  B2_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
#pragma unroll
  for (int j = 0; j < Q; j++) {
    ha[j] ^= a[j] ^ c[j];
    hb[j] ^= b[j] ^ d[j];
  }
}

// This thread's columns of a chain value into st[8] where `store`
template <int L>
DEV void b2_store_state(const B2Cols<L>& k, uint64_t* st, const uint64_t (&ha)[4 / L], const uint64_t (&hb)[4 / L],
                        bool store) {
#pragma unroll
  for (int j = 0; j < 4 / L; j++) {
    if (store) {
      st[k.col(j)] = ha[j];
      st[4 + k.col(j)] = hb[j];
    }
  }
}

// Digest word c (< 4) of a chain value as LE64 (lo, hi) int64 values
DEV void b2_put_word(int64_t* out, int c, uint64_t v) {
  out[2 * c] = (int64_t)(v & 0xffffffffull);
  out[2 * c + 1] = (int64_t)(v >> 32);
}

// Shared memory of a block of `rows` rows: the staged bytes (nb blocks of
// 128 a row, none unstaged), the chain states (8 words each; staged, nb a
// row: after each block; unstaged, S a row: at each squeeze's final block),
// a 16-word message slot a group, the S squeeze lengths and the squeezes in
// the order of their final blocks.
struct B2Layout {
  int nb, rows, S;
  bool staged;
  __host__ __device__ int n_states() const { return staged ? nb : S; }
  __host__ __device__ size_t bytes_words() const { return staged ? (size_t)rows * nb * B2_WORDS : 0; }
  __host__ __device__ size_t state_words() const { return (size_t)rows * n_states() * 8; }
  __host__ __device__ size_t slot_words(int threads, int lanes) const { return (size_t)(threads / lanes) * B2_WORDS; }
  __host__ __device__ size_t words(int threads, int lanes) const {
    return bytes_words() + state_words() + slot_words(threads, lanes) + S;
  }
};

// The LE64 word of bytes p .. p + 7 of a row in global memory, bytes at or
// past n zero
DEV uint64_t b2_gword(const uint8_t* row, int p, int n) {
  uint64_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; i++)
    if (p + i < n) x |= (uint64_t)LDG(row + p + i) << (8 * i);
  return x;
}

// Unstaged: block blk of a row (T bytes in global memory) into the group's
// message slot, word l + L i on lane l, then the group's lanes meet
template <int L>
DEV void b2_load_block(const B2Cols<L>& k, uint64_t* slot, const uint8_t* row, int blk, int T) {
#pragma unroll
  for (int i = 0; i < B2_WORDS / L; i++) {
    const int w = k.l + L * i;
    slot[w] = b2_gword(row, 128 * blk + 8 * w, T);
  }
  __syncwarp(FULL);
}

// After `blk` chain blocks: the state of every squeeze whose final block is
// blk into its place in st (S states of 8 words) where `store`. ord: the
// squeezes by final block, c: the first not kept yet; returns the next.
template <int L>
DEV int b2_keep_states(const B2Cols<L>& k, uint64_t* st, const int* lens, const int* ord, int S, int c, int blk,
                       const uint64_t (&ha)[4 / L], const uint64_t (&hb)[4 / L], bool store) {
  for (; c < S; c++) {
    const int s = ord[c];
    if ((lens[s] - 1) >> 7 != blk) break;
    b2_store_state<L>(k, st + 8 * s, ha, hb, store);
  }
  return c;
}

// Stages the block's rows into bytes (rows x row_bytes): the n rows from
// row0 are one contiguous range of buf, read as aligned 16-byte vectors
// (its unaligned ends byte by byte, threads on neighbouring addresses) and
// scattered to their rows; bytes past T and rows past the n read as zero.
DEV void b2_stage(uint8_t* bytes, const uint8_t* buf, int row0, int n, int rows, int T, int row_bytes) {
  const int tid = threadIdx.x, nt = blockDim.x, keep = min(T, row_bytes);
  const uint8_t* lo = buf + (size_t)row0 * T;
  const uint8_t* hi = lo + (size_t)n * T;
  const uint8_t* vlo = reinterpret_cast<const uint8_t*>(((uintptr_t)lo + 15) & ~(uintptr_t)15);
  const uint8_t* vhi = reinterpret_cast<const uint8_t*>((uintptr_t)hi & ~(uintptr_t)15);
  if (vhi < vlo) vlo = vhi = hi;  // under one vector: all bytes one by one
  // byte i of the range is byte p of row r
  auto put = [&](int i, uint32_t v) {
    const int r = i / T, p = i - r * T;
    if (p < keep) bytes[r * row_bytes + p] = (uint8_t)v;
  };
  if (tid < vlo - lo) put(tid, LDG(lo + tid));
  if (tid < hi - vhi) put((int)(vhi - lo) + tid, LDG(vhi + tid));
  for (const uint8_t* x = vlo + 16 * tid; x < vhi; x += 16 * nt) {
    const uint4 w = LDG(reinterpret_cast<const uint4*>(x));
    const uint32_t q[4] = {w.x, w.y, w.z, w.w};
    const int i = (int)(x - lo);
    int r = i / T, p = i - r * T;  // then stepped byte by byte
#pragma unroll
    for (int k = 0; k < 16; k++) {
      if (p < keep) bytes[r * row_bytes + p] = (uint8_t)(q[k >> 2] >> (8 * (k & 3)));
      if (++p == T) {
        p = 0;
        r++;
      }
    }
  }
  // zeros: bytes keep .. row_bytes of every row, and the rows past n
  const int tail = row_bytes - keep;
  for (int i = tid; i < rows * tail; i += nt) bytes[(i / tail) * row_bytes + keep + i % tail] = 0;
  for (int i = tid; i < (rows - n) * keep; i += nt) bytes[(n + i / keep) * row_bytes + i % keep] = 0;
}

// B rows of T bytes; lens[S] the squeeze lengths (each >= 1), then lens[S +
// i] the squeezes in the order of their final blocks (len - 1) / 128, ties
// by index; max_fb the largest final block. `rows` rows a block, `groups`
// groups of L lanes a row, blockDim.x the rows' lanes rounded up to whole
// warps; STAGED: the rows' bytes in shared memory, else read from buf
// block by block.
template <int L, bool STAGED>
__global__ void __launch_bounds__(B2_MAX_THREADS)
transcript_kernel(const uint8_t* buf, int B, int T, const int* lens, int S, int max_fb, int rows, int groups,
                  int64_t* h1_out, int64_t* h2_out) {
  constexpr int Q = 4 / L;
  extern __shared__ __align__(16) uint32_t smem[];
  const B2Layout lay{max_fb + 1, rows, S, STAGED};
  const int tid = threadIdx.x, q = tid / L, row0 = blockIdx.x * rows;
  uint64_t* words = reinterpret_cast<uint64_t*>(smem);  // (rows, nb * 16), staged
  uint64_t* states = words + lay.bytes_words();          // (rows, nb or S, 8)
  uint64_t* slots = states + lay.state_words();          // (groups in the block, 16)
  int* lens_s = reinterpret_cast<int*>(slots + lay.slot_words(blockDim.x, L));  // (S)
  int* ord = lens_s + S;                                                        // (S)
  uint64_t* slot = slots + (size_t)q * B2_WORDS;
  const B2Cols<L> k(tid % L);
  const int row_bytes = lay.nb * 128;

  if (STAGED) b2_stage(reinterpret_cast<uint8_t*>(words), buf, row0, min(rows, B - row0), rows, T, row_bytes);
  for (int i = tid; i < 2 * S; i += blockDim.x) lens_s[i] = LDG(lens + i);  // and ord
  __syncthreads();

  // phase 1: group q < rows runs row q's chain; the groups of the warp that
  // holds the last chain group run the last row with it
  const int chain_groups = (rows * L + 31) / 32 * 32 / L;
  if (q < chain_groups) {
    const int r = min(q, rows - 1);
    const uint8_t* src = buf + (size_t)min(row0 + r, B - 1) * T;
    uint64_t ha[Q], hb[Q];
    k.init(ha, hb);
    uint64_t* st = states + (size_t)r * lay.n_states() * 8;
    if constexpr (STAGED) {
      b2_store_state<L>(k, st, ha, hb, q < rows);
      for (int blk = 0; blk < max_fb; blk++) {
        b2_compress<L>(k, ha, hb, words + ((size_t)r * lay.nb + blk) * B2_WORDS, 128ull * (blk + 1), false);
        st += 8;
        b2_store_state<L>(k, st, ha, hb, q < rows);
      }
    } else {
      int c = b2_keep_states<L>(k, st, lens_s, ord, S, 0, 0, ha, hb, q < rows);
      for (int blk = 0; blk < max_fb; blk++) {
        b2_load_block<L>(k, slot, src, blk, T);
        b2_compress<L>(k, ha, hb, slot, 128ull * (blk + 1), false);
        __syncwarp(FULL);
        c = b2_keep_states<L>(k, st, lens_s, ord, S, c, blk + 1, ha, hb, q < rows);
      }
    }
  }
  __syncthreads();

  // phases 2 and 3: group g of row r takes squeezes g, g + groups, ...
  const int r = q / groups, gi = q - r * groups, rc = min(r, rows - 1), row = row0 + r;
  const bool live_row = r < rows && row < B;
  const uint64_t* row_words = words + (size_t)rc * lay.nb * B2_WORDS;
  const uint8_t* src = buf + (size_t)min(row0 + rc, B - 1) * T;
  for (int s0 = 0; s0 < S; s0 += groups) {
    const int s = min(s0 + gi, S - 1), len = lens_s[s], fb = (len - 1) / 128;
    const bool store = live_row && s0 + gi < S;
    uint64_t ha[Q], hb[Q];
    const uint64_t* st = states + ((size_t)rc * lay.n_states() + (STAGED ? fb : s)) * 8;
#pragma unroll
    for (int j = 0; j < Q; j++) {
      ha[j] = st[k.col(j)];
      hb[j] = st[4 + k.col(j)];
    }
    // the final block, masked by words: bytes at or past len are zero
#pragma unroll
    for (int i = 0; i < B2_WORDS / L; i++) {
      const int w = k.l + L * i, nb = min(max(len - 128 * fb - 8 * w, 0), 8);
      const uint64_t x = STAGED ? row_words[fb * B2_WORDS + w] : b2_gword(src, 128 * fb + 8 * w, T);
      slot[w] = nb == 8 ? x : x & ((1ull << (8 * nb)) - 1);
    }
    __syncwarp(FULL);
    b2_compress<L>(k, ha, hb, slot, (uint64_t)len, true);
    int64_t* o1 = h1_out + ((size_t)row * S + s) * 8;
    __syncwarp(FULL);
    // h2's message: the 32-byte digest h1 (the a-row), then zeros
#pragma unroll
    for (int j = 0; j < Q; j++) {
      const int c = k.col(j);
      if (store) b2_put_word(o1, c, ha[j]);
      slot[c] = ha[j];
      slot[4 + c] = slot[8 + c] = slot[12 + c] = 0;
    }
    __syncwarp(FULL);
    k.init(ha, hb);
    b2_compress<L>(k, ha, hb, slot, 32, true);
    int64_t* o2 = h2_out + ((size_t)row * S + s) * 8;
#pragma unroll
    for (int j = 0; j < Q; j++)
      if (store) b2_put_word(o2, k.col(j), ha[j]);
    __syncwarp(FULL);
  }
}

// Launch shape: `rows` rows a block (0: the fewest that put every row in
// one wave of blocks, one block a SM), as many groups a row as fit up to
// one a squeeze, at most B2_MAX_THREADS threads. The rows' bytes are
// staged where they fit, with fewer rows a block if need be, else read from
// global memory. Returns the threads a block (rows, groups, staged and the
// shared bytes set), or 0 where not even one unstaged row fits.
static inline int transcript_shape(int B, int S, int max_fb, int lanes, int& rows, int& groups, bool& staged,
                                   size_t& smem) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rows <= 0) rows = std::max(1, std::min((B + sms - 1) / std::max(sms, 1), B2_MAX_THREADS / (S * lanes)));
  for (int st = 1; st >= 0; st--)
    for (int r = rows; r >= 1; r--) {
      const int g = std::max(1, std::min(S, B2_MAX_THREADS / (r * lanes)));
      const int threads = (r * g * lanes + 31) / 32 * 32;
      const size_t bytes = sizeof(uint64_t) * B2Layout{max_fb + 1, r, S, st == 1}.words(threads, lanes);
      if (threads <= B2_MAX_THREADS && bytes <= (size_t)smem_max) {
        rows = r;
        groups = g;
        staged = st == 1;
        smem = bytes;
        return threads;
      }
    }
  return 0;
}

template <int L>
static int launch_transcript(const uint8_t* buf, int B, int T, const int* lens, int S, int max_fb, int64_t* h1,
                             int64_t* h2, int rows, cudaStream_t st) {
  int groups = 0;
  bool staged = true;
  size_t smem = 0;
  const int threads = transcript_shape(B, S, max_fb, L, rows, groups, staged, smem);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const auto kernel = staged ? transcript_kernel<L, true> : transcript_kernel<L, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + rows - 1) / rows, threads, smem, st>>>(buf, B, T, lens, S, max_fb, rows, groups, h1, h2);
  return (int)cudaGetLastError();
}

// lanes: 1 or 4 a compression; rows: 0 for the default above
extern "C" int ph2_transcript(const uint8_t* buf, int B, int T, const int* lens, int S, int max_fb, int64_t* h1,
                              int64_t* h2, int lanes, int rows, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (S < 1 || max_fb < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 4) return launch_transcript<4>(buf, B, T, lens, S, max_fb, h1, h2, rows, st);
  if (lanes == 1) return launch_transcript<1>(buf, B, T, lens, S, max_fb, h1, h2, rows, st);
  return (int)cudaErrorInvalidValue;
}
