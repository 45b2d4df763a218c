// Static-exponent pow kernel: replaces plutus_halo2_tpu/ops/pallas_field.py:32
// (make_pow_kernel, pallas_call at :61).
//
// What it computes: x^e for every element of an (n, L) slab of Montgomery
// limbs, e static and given as its MSB-first 4-bit window digits. On the
// verifier's path: the Fr Fermat inversion (e = q - 2, 64 digits, one
// element per proof) and the Fp square-root ladder of hintless
// decompression (e = (p + 1) / 4, 96 digits, ten elements per proof).
//
// Bound: integer multiply throughput. Per element, 14 table products, then
// per later digit 4 squarings and a table product unless the digit is 0,
// each a CIOS product of 2 NW^2 + NW 32x32 word multiplies: Fp (p+1)/4
// (95 digits): 481 * 300 = 144,300 multiplies; Fr q-2 (64 digits): 325 *
// 136 = 44,200. The kernel adds 2 boundary products and multiplies by the
// table's 1 on zero digits.
//
// Design: one thread per element, the 16-entry power table in local memory
// (L1-resident), the digit schedule read from global memory (broadcast).
// Blocks of 64 threads (the caller's choice; see ops/_build.py).
#include "field.cuh"

struct GlobalDigits {
  const int* d;
  DEV int operator()(int w) const { return LDG(d + w); }
};

template <class F>
__global__ void pow_kernel(const int64_t* x, int64_t* out, int n, const int* digits, int nd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[F::NW], acc[F::NW];
  load_port<F>(a, x + (size_t)i * F::L16);
  pow_window<F>(acc, a, GlobalDigits{digits}, nd);
  store_port<F>(out + (size_t)i * F::L16, acc);
}

template <class F>
static int launch_pow(const int64_t* x, int64_t* out, int n, const int* digits, int nd, int tpb,
                      void* stream) {
  if (n > 0) {
    pow_kernel<F><<<(n + tpb - 1) / tpb, tpb, 0, (cudaStream_t)stream>>>(x, out, n, digits, nd);
  }
  return (int)cudaGetLastError();
}

extern "C" int ph2_pow_fp(const int64_t* x, int64_t* out, int n, const int* digits, int nd,
                          int tpb, void* stream) {
  return launch_pow<FpT>(x, out, n, digits, nd, tpb, stream);
}

extern "C" int ph2_pow_fr(const int64_t* x, int64_t* out, int n, const int* digits, int nd,
                          int tpb, void* stream) {
  return launch_pow<FrT>(x, out, n, digits, nd, tpb, stream);
}
