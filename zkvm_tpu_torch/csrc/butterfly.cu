// Radix-2 NTT butterfly over Fr on limb-major [..., 8, B] batches:
//   plus = even + tw * odd,  minus = even - tw * odd   (all mod r).
//
// Replaces zkvm_tpu/ops/pallas_field.py:butterfly_pallas (kernel
// _butterfly_kernel).  The TPU kernel fuses the multiply and the two
// additions over a [16, block] tile of 16-bit limbs; here each thread owns
// one lane pair, keeps the three operands in registers as 32-bit limbs and
// writes both results, so the product never goes to memory.  Limb i of lane
// b sits at i * B + b: a warp's loads of one limb row are contiguous.  The
// twiddles are either one [8, B] table shared by every group (group stride
// 0) or a tensor shaped like the operands.  Moves 5 x 32 bytes per lane
// pair for 2 * 64 + 8 limb products: bounded by memory.
#include "common.cuh"
#include "field.cuh"

namespace {

__global__ void butterfly_kernel(const uint32_t* __restrict__ even,
                                 const uint32_t* __restrict__ odd,
                                 const uint32_t* __restrict__ tw,
                                 uint32_t* __restrict__ plus,
                                 uint32_t* __restrict__ minus,
                                 long long groups, long long lanes,
                                 long long tw_group_stride) {
  constexpr int N = zk::Fr::N;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long lane = t - g * lanes;
  const long long base = g * N * lanes + lane;
  const long long tbase = g * tw_group_stride + lane;
  uint32_t e[N], o[N], w[N], r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    e[i] = even[base + i * lanes];
    o[i] = odd[base + i * lanes];
    w[i] = tw[tbase + i * lanes];
  }
  zk::mont_mul<zk::Fr>(o, o, w);
  zk::add<zk::Fr>(r, e, o);
#pragma unroll
  for (int i = 0; i < N; ++i) plus[base + i * lanes] = r[i];
  zk::sub<zk::Fr>(r, e, o);
#pragma unroll
  for (int i = 0; i < N; ++i) minus[base + i * lanes] = r[i];
}

}  // namespace

// tw_group_stride: words between one group's twiddles and the next (0 when
// every group shares one [8, lanes] table).  Returns cudaGetLastError().
extern "C" int zk_butterfly(const void* even, const void* odd, const void* tw,
                            void* plus, void* minus, long long groups,
                            long long lanes, long long tw_group_stride,
                            void* stream) {
  const unsigned grid = zk::blocks_for(groups * lanes, zk::kThreads);
  butterfly_kernel<<<grid, zk::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)even, (const uint32_t*)odd, (const uint32_t*)tw,
      (uint32_t*)plus, (uint32_t*)minus, groups, lanes, tw_group_stride);
  return (int)cudaGetLastError();
}
