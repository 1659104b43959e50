// Elementwise Montgomery product over limb-major [..., L, B] batches.
//
// Replaces zkvm_tpu/ops/pallas_field.py:mont_mul_pallas (kernel
// _mont_mul_ew_kernel -> _mont_mul_k).  The TPU kernel multiplies 16-bit
// limbs on the vector unit, a [L, block] tile per grid step; here each
// thread owns one lane and keeps both operands in registers as 32-bit
// limbs.  Limb i of lane b sits at i * B + b, so a warp's loads of one limb
// row are contiguous (coalesced).  Bounded by integer multiply throughput:
// 2 N^2 + N 32-bit products per lane, 1 load and store word per limb.
#include "common.cuh"
#include "field.cuh"

namespace {

template <class F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long groups,
                                long long lanes) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long base = g * F::N * lanes + (t - g * lanes);
  uint32_t x[F::N], y[F::N], r[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) {
    x[i] = a[base + i * lanes];
    y[i] = b[base + i * lanes];
  }
  zk::mont_mul<F>(r, x, y);
#pragma unroll
  for (int i = 0; i < F::N; ++i) out[base + i * lanes] = r[i];
}

}  // namespace

// field: 0 = Fr (8 limbs), 1 = Fq (12 limbs).  Returns cudaGetLastError().
extern "C" int zk_mont_mul(int field, const void* a, const void* b, void* out,
                           long long groups, long long lanes, void* stream) {
  const long long n = groups * lanes;
  const unsigned grid = zk::blocks_for(n, zk::kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (field == 0) {
    mont_mul_kernel<zk::Fr><<<grid, zk::kThreads, 0, s>>>(pa, pb, po, groups,
                                                          lanes);
  } else if (field == 1) {
    mont_mul_kernel<zk::Fq><<<grid, zk::kThreads, 0, s>>>(pa, pb, po, groups,
                                                          lanes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
