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
// 9 final + 9 h2 = 27 compressions of 12 rounds x 8 G steps x 8 64-bit ops.
//
// Design: one thread per row with native uint64_t words; the 16 message
// words and the state live in registers (the round loop is unrolled so the
// SIGMA schedule is static); rows are 1.3 KB apart, read byte by byte.
#include "field.cuh"

static __constant__ uint64_t B2_IV[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
    0x510e527fade682d1ull, 0x9b05688c2b3e6c1full, 0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};

DEV uint64_t rotr64(uint64_t x, int r) { return (x >> r) | (x << (64 - r)); }

#define B2_G(a, b, c, d, x, y)       \
  do {                               \
    v[a] = v[a] + v[b] + (x);        \
    v[d] = rotr64(v[d] ^ v[a], 32);  \
    v[c] = v[c] + v[d];              \
    v[b] = rotr64(v[b] ^ v[c], 24);  \
    v[a] = v[a] + v[b] + (y);        \
    v[d] = rotr64(v[d] ^ v[a], 16);  \
    v[c] = v[c] + v[d];              \
    v[b] = rotr64(v[b] ^ v[c], 63);  \
  } while (0)

#define B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                              \
    B2_G(0, 4, 8, 12, m[s0], m[s1]);                                                \
    B2_G(1, 5, 9, 13, m[s2], m[s3]);                                                \
    B2_G(2, 6, 10, 14, m[s4], m[s5]);                                               \
    B2_G(3, 7, 11, 15, m[s6], m[s7]);                                               \
    B2_G(0, 5, 10, 15, m[s8], m[s9]);                                               \
    B2_G(1, 6, 11, 12, m[s10], m[s11]);                                             \
    B2_G(2, 7, 8, 13, m[s12], m[s13]);                                              \
    B2_G(3, 4, 9, 14, m[s14], m[s15]);                                              \
  } while (0)

// One compression of h with message m, byte counter t (< 2^64), final flag.
DEV_NOINLINE void b2_compress(uint64_t* h, const uint64_t* m, uint64_t t, bool last) {
  uint64_t v[16];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    v[i] = h[i];
    v[i + 8] = B2_IV[i];
  }
  v[12] ^= t;
  if (last) v[14] = ~v[14];
  // 12 rounds; the message schedule SIGMA[r % 10] is spelled out so every
  // message index is a compile-time constant (m stays in registers)
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
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

DEV void b2_init(uint64_t* h) {
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = B2_IV[i];
  h[0] ^= 0x01010020ull;  // parameter block: digest 32 bytes, fanout 1, depth 1
}

// Digest words of h (the first 32 bytes) as LE64 (lo, hi) int64 values.
DEV void b2_store(int64_t* out, const uint64_t* h) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    out[2 * i] = (int64_t)(h[i] & 0xffffffffull);
    out[2 * i + 1] = (int64_t)(h[i] >> 32);
  }
}

// The per-row work; `row` holds T bytes (bytes past T read as zero).
DEV void transcript_row(const uint8_t* row, int T, const int* lens, int S, int64_t* h1_out,
                        int64_t* h2_out) {
  int max_fb = 0;
  for (int s = 0; s < S; s++) max_fb = max(max_fb, (LDG(lens + s) - 1) / 128);
  uint64_t h[8];
  b2_init(h);
  for (int j = 0; j <= max_fb; j++) {
    uint64_t m[16];
    for (int w = 0; w < 16; w++) {
      uint64_t x = 0;
      for (int k = 0; k < 8; k++) {
        const int p = 128 * j + 8 * w + k;
        x |= (uint64_t)(p < T ? row[p] : 0) << (8 * k);
      }
      m[w] = x;
    }
    for (int s = 0; s < S; s++) {
      const int len = LDG(lens + s);
      if ((len - 1) / 128 != j) continue;
      uint64_t mf[16], hf[8], h2[8], m2[16];
      for (int w = 0; w < 16; w++) {
        const int nb = min(max(len - 128 * j - 8 * w, 0), 8);  // live bytes of word w
        mf[w] = nb == 8 ? m[w] : (m[w] & ((1ull << (8 * nb)) - 1));
      }
      for (int i = 0; i < 8; i++) hf[i] = h[i];
      b2_compress(hf, mf, (uint64_t)len, true);
      b2_store(h1_out + 8 * s, hf);
      b2_init(h2);
      for (int w = 0; w < 16; w++) m2[w] = w < 4 ? hf[w] : 0;
      b2_compress(h2, m2, 32, true);
      b2_store(h2_out + 8 * s, h2);
    }
    if (j < max_fb) b2_compress(h, m, (uint64_t)(128 * (j + 1)), false);
  }
}

__global__ void transcript_kernel(const uint8_t* buf, int B, int T, const int* lens, int S,
                                  int64_t* h1, int64_t* h2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  transcript_row(buf + (size_t)b * T, T, lens, S, h1 + (size_t)b * S * 8, h2 + (size_t)b * S * 8);
}

extern "C" int ph2_transcript(const uint8_t* buf, int B, int T, const int* lens, int S, int64_t* h1,
                              int64_t* h2, int tpb, void* stream) {
  if (B > 0) {
    transcript_kernel<<<(B + tpb - 1) / tpb, tpb, 0, (cudaStream_t)stream>>>(buf, B, T, lens, S, h1, h2);
  }
  return (int)cudaGetLastError();
}
