// Complete G1 addition over limb-major [..., 12, B] projective batches.
//
// Replaces zkvm_tpu/ops/pallas_field.py:padd_pallas_2l (kernel
// _padd_kernel -> _padd_vals, multiply _mont_mul_scr2).  One thread per
// lane runs RCB15 algorithm 7 (a = 0) in registers: 14 Fq products
// (12 variable, 2 by 3b) and 13 additions/subtractions, in the reference's
// formula order, so outputs match bit for bit.  It also serves every
// doubling (p == q).  Bounded by integer multiply throughput (~4.2k 32-bit
// products per lane) and by registers (~150 live words per lane, so few
// warps per SM); the design is the simple one, one lane per thread.
#include "common.cuh"
#include "field.cuh"

namespace {

constexpr int kPaddThreads = 128;

__device__ __forceinline__ void load(uint32_t* dst, const uint32_t* src,
                                     long long base, long long lanes) {
#pragma unroll
  for (int i = 0; i < zk::Fq::N; ++i) dst[i] = src[base + i * lanes];
}

__device__ __forceinline__ void store(uint32_t* dst, const uint32_t* src,
                                      long long base, long long lanes) {
#pragma unroll
  for (int i = 0; i < zk::Fq::N; ++i) dst[base + i * lanes] = src[i];
}

__global__ void padd_kernel(const uint32_t* __restrict__ x1,
                            const uint32_t* __restrict__ y1,
                            const uint32_t* __restrict__ z1,
                            const uint32_t* __restrict__ x2,
                            const uint32_t* __restrict__ y2,
                            const uint32_t* __restrict__ z2,
                            uint32_t* __restrict__ x3,
                            uint32_t* __restrict__ y3,
                            uint32_t* __restrict__ z3, long long groups,
                            long long lanes) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long base = g * zk::Fq::N * lanes + (t - g * lanes);
  zk::G1 p, q;
  load(p.x, x1, base, lanes);
  load(p.y, y1, base, lanes);
  load(p.z, z1, base, lanes);
  load(q.x, x2, base, lanes);
  load(q.y, y2, base, lanes);
  load(q.z, z2, base, lanes);
  zk::g1_add(p, p, q);
  store(x3, p.x, base, lanes);
  store(y3, p.y, base, lanes);
  store(z3, p.z, base, lanes);
}

}  // namespace

extern "C" int zk_padd(const void* x1, const void* y1, const void* z1,
                       const void* x2, const void* y2, const void* z2,
                       void* x3, void* y3, void* z3, long long groups,
                       long long lanes, void* stream) {
  const unsigned grid = zk::blocks_for(groups * lanes, kPaddThreads);
  padd_kernel<<<grid, kPaddThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, groups, lanes);
  return (int)cudaGetLastError();
}
