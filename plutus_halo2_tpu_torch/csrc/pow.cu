// Static-exponent pow kernel: replaces plutus_halo2_tpu/ops/pallas_field.py:32
// (make_pow_kernel, pallas_call at :61).
//
// What it computes: x^e for every element of an (n, L) slab of Montgomery
// limbs, e static and given as its MSB-first 4-bit window digits. On the
// verifier's path: the Fr Fermat inversion (e = q - 2, 64 digits, one
// element per proof). The Fp square-root ladder of hintless decompression
// (e = (p + 1) / 4, 95 digits) runs this kernel's ladder inside the
// hintless decompress kernel (sqrt_decode.cu).
//
// Bound: integer multiply throughput. Per element, 14 table products, then
// per later digit 4 squarings and a table product unless the digit is 0,
// each a CIOS product of 2 NW^2 + NW 32x32 word multiplies: Fp (p+1)/4
// (95 digits): 481 * 300 = 144,300 multiplies; Fr q-2 (64 digits): 325 *
// 136 = 44,200. The kernel adds 2 boundary products.
//
// Design: each element's ladder is a chain of dependent products, so one
// thread an element waits a whole product per step and leaves most of the
// card idle at the verifier's widths (1,024 Fr elements). Here an element
// belongs to a group of T = POW_LANES lanes (lanes.cuh: T lanes share each
// product, S = NW / T words a lane, the multiplier's words gathered by
// shuffles), POW_ROWS elements a block: one warp. The 16-entry power table
// is in shared memory, each lane reading and writing its own S words of an
// entry; the digit is the same for every element, so a warp's reads fall
// on one entry and spread over the banks. The digit schedule is a device
// array read by broadcast; a zero digit's product by the table's 1 is
// skipped (it is the identity on a fully reduced value). Any n >= 0.
#include "lanes.cuh"

// words of one element's table in shared memory: 16 entries, padded to NW
// mod 32 so that a warp's groups read different banks
template <class F>
__host__ __device__ constexpr int tab_words() {
  return 16 * F::NW + ((F::NW - (16 * F::NW) % 32) + 32) % 32;
}

template <class F, int T>
__global__ void __launch_bounds__(256) pow_kernel(const int64_t* x, int64_t* out, int n, const int* digits,
                                                  int nd) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int NW = F::NW, S = NW / T;
  const int slot = threadIdx.x / T;
  // the ragged edge's groups run on the last element and store nothing:
  // the shuffles need every lane of the warp (lanes.cuh)
  const int i = blockIdx.x * (blockDim.x / T) + slot;
  const bool live = i < n;
  const Lanes<F, T> g(threadIdx.x % T);
  uint32_t* tab = smem + (size_t)slot * tab_words<F>() + g.l * S;  // this lane's words of entry 0
  // in: limb pairs to words, then times to_k into the kernel's domain
  const int64_t* src = x + (size_t)(live ? i : n - 1) * F::L16 + 2 * g.l * S;
  uint32_t w[S], a[NW], full[NW], acc[S];
#pragma unroll
  for (int s = 0; s < S; s++) w[s] = (uint32_t)src[2 * s] | ((uint32_t)src[2 * s + 1] << 16);
#pragma unroll
  for (int k = 0; k < NW; k++) full[k] = F::to_k(k);
  f_mul_lanes<F, T>(acc, full, w, g);
  // the table [1, x, ..., x^15]
  lanes_gather<F, T>(a, acc, g);
#pragma unroll
  for (int s = 0; s < S; s++) {
    tab[s] = F::one(g.l * S + s);
    tab[NW + s] = acc[s];
  }
#pragma unroll 1
  for (int k = 2; k < 16; k++) {
    f_mul_lanes<F, T>(acc, a, acc, g);
#pragma unroll
    for (int s = 0; s < S; s++) tab[k * NW + s] = acc[s];
  }
  int d = LDG(digits);
#pragma unroll
  for (int s = 0; s < S; s++) acc[s] = tab[d * NW + s];
#pragma unroll 1
  for (int k = 1; k < nd; k++) {
#pragma unroll 1
    for (int q = 0; q < 4; q++) {
      lanes_gather<F, T>(full, acc, g);
      f_mul_lanes<F, T>(acc, full, acc, g);
    }
    d = LDG(digits + k);
    if (d != 0) {
      uint32_t e[S];
#pragma unroll
      for (int s = 0; s < S; s++) e[s] = tab[d * NW + s];
      lanes_gather<F, T>(full, acc, g);
      f_mul_lanes<F, T>(acc, full, e, g);
    }
  }
  // out: times from_k, words to limb pairs; the limbs past 2 NW are zero
#pragma unroll
  for (int k = 0; k < NW; k++) full[k] = F::from_k(k);
  f_mul_lanes<F, T>(acc, full, acc, g);
  if (!live) return;
  int64_t* dst = out + (size_t)i * F::L16;
#pragma unroll
  for (int s = 0; s < S; s++) {
    dst[2 * (g.l * S + s)] = acc[s] & 0xffffu;
    dst[2 * (g.l * S + s) + 1] = acc[s] >> 16;
  }
  if (g.l == T - 1)
    for (int k = 2 * NW; k < F::L16; k++) dst[k] = 0;
}

// The launch geometry, for both fields: the fastest on an H100 at the
// verifier's shapes in kernel-alone sweeps over 2, 4 and (Fr) 8 lanes and
// 4 to 32 elements a block
constexpr int POW_LANES = 4;
constexpr int POW_ROWS = 8;

template <class F>
static int launch_pow(const int64_t* x, int64_t* out, int n, const int* digits, int nd, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(uint32_t) * POW_ROWS * tab_words<F>();
  cudaError_t e =
      cudaFuncSetAttribute(pow_kernel<F, POW_LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pow_kernel<F, POW_LANES><<<(n + POW_ROWS - 1) / POW_ROWS, POW_ROWS * POW_LANES, smem, (cudaStream_t)stream>>>(
      x, out, n, digits, nd);
  return (int)cudaGetLastError();
}

extern "C" int ph2_pow_fp(const int64_t* x, int64_t* out, int n, const int* digits, int nd, void* stream) {
  return launch_pow<FpT>(x, out, n, digits, nd, stream);
}

extern "C" int ph2_pow_fr(const int64_t* x, int64_t* out, int n, const int* digits, int nd, void* stream) {
  return launch_pow<FrT>(x, out, n, digits, nd, stream);
}
