// Elementwise Montgomery-product test kernel for the device field library:
// the counterpart of the test-only pallas_call in
// tests/test_pallas_core.py:123 (test_pallas_call_interpret_mul, :139).
//
// What it computes: a * b / R for every element pair of two (n, L) slabs of
// the port's Montgomery limbs, through load_port / f_mul / store_port, so a
// field-library bug shows up here before it hides inside a larger kernel.
//
// Bound: integer multiply throughput, 4 CIOS products per element (two
// input conversions, the product, one output conversion): Fp 4 * 288 =
// 1,152 and Fr 4 * 128 = 512 32x32 word multiplies.
//
// Design: one thread per element.
#include "field.cuh"

template <class F>
__global__ void mont_mul_kernel(const int64_t* a, const int64_t* b, int64_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::NW], y[F::NW];
  load_port<F>(x, a + (size_t)i * F::L16);
  load_port<F>(y, b + (size_t)i * F::L16);
  f_mul<F>(x, x, y);
  store_port<F>(out + (size_t)i * F::L16, x);
}

template <class F>
static int launch_mont_mul(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  if (n > 0) mont_mul_kernel<F><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int ph2_mont_mul_fp(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  return launch_mont_mul<FpT>(a, b, out, n, stream);
}

extern "C" int ph2_mont_mul_fr(const int64_t* a, const int64_t* b, int64_t* out, int n, void* stream) {
  return launch_mont_mul<FrT>(a, b, out, n, stream);
}
