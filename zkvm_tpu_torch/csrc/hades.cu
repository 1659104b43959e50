// The Hades permutation (Poseidon, width 5, 8 full + 60 partial rounds,
// S-box x^5, dense 5 x 5 MDS) over a limb-major [5, 8, B] batch of Fr states.
//
// Replaces zkvm_tpu/ops/pallas_field.py:hades_permute_pallas (kernel
// _hades_kernel).  A round adds the round constants, raises words to the
// fifth power (three products) and multiplies by the MDS matrix (25
// products by constants, 20 additions); every add and product is fully
// reduced, so each intermediate is the canonical value and the result
// equals the reference's bit for bit.
//
// One thread per lane keeps the 5 x 8 state words in registers for all 68
// rounds.  The reference raises all five words in every round and selects
// by a mask, because its body must be uniform; here the round index is the
// same for every thread, so a partial round branches past the 12 unused
// products: 8 (15 + 25) + 60 (3 + 25) = 2000 Fr products a permutation.
// The constants (68 x 5 round constants and the matrix, 11,680 bytes in
// Montgomery form) are staged into shared memory once per block and read
// from there by every thread at the same address (a broadcast).
//
// Bounded by integer multiply throughput: 2000 products of 272 32-bit
// multiply-adds against 320 bytes of traffic a lane.  The round loop is
// not unrolled (one round's body is already 28 to 40 inlined products);
// the loops over the five words are, so that the state stays in registers.
// Left alone, ptxas takes all 255 registers (two live copies of the state
// beside the products it interleaves) and two blocks fit an SM; the launch
// bounds ask for three blocks (168 registers, about 500 bytes of spills),
// which was the fastest of one to four blocks at 2^18 lanes and above.  A
// launch of up to 2^14 lanes is one wave of single warps and takes the
// time of one thread's 2000 dependent products, whatever the batch.
#include "common.cuh"
#include "field.cuh"

namespace {

constexpr int kHadesThreads = 128;
constexpr int kHadesBlocksPerSm = 3;
constexpr int kWidth = 5;
constexpr int kRounds = 68;
constexpr int kHalfFull = 4;   // full rounds at each end
constexpr int kPartial = 60;
constexpr int kLimbs = zk::Fr::N;
constexpr int kArcWords = kRounds * kWidth * kLimbs;
constexpr int kConstWords = kArcWords + kWidth * kWidth * kLimbs;

// x <- x^5
__device__ __forceinline__ void sbox(uint32_t* x) {
  uint32_t x2[kLimbs], x4[kLimbs];
  zk::mont_mul<zk::Fr>(x2, x, x);
  zk::mont_mul<zk::Fr>(x4, x2, x2);
  zk::mont_mul<zk::Fr>(x, x4, x);
}

__global__ void __launch_bounds__(kHadesThreads, kHadesBlocksPerSm)
hades_kernel(const uint32_t* __restrict__ state,
             const uint32_t* __restrict__ consts,
             uint32_t* __restrict__ out, long long lanes) {
  __shared__ uint32_t c[kConstWords];
  for (int i = threadIdx.x; i < kConstWords; i += kHadesThreads)
    c[i] = consts[i];
  __syncthreads();
  const long long t = (long long)blockIdx.x * kHadesThreads + threadIdx.x;
  if (t >= lanes) return;

  uint32_t s[kWidth][kLimbs];
#pragma unroll
  for (int w = 0; w < kWidth; ++w)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
      s[w][j] = state[((long long)w * kLimbs + j) * lanes + t];

  const uint32_t* mds = c + kArcWords;
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t* arc = c + r * (kWidth * kLimbs);
#pragma unroll
    for (int w = 0; w < kWidth; ++w)
      zk::add<zk::Fr>(s[w], s[w], arc + w * kLimbs);
    if (r < kHalfFull || r >= kHalfFull + kPartial) {
#pragma unroll
      for (int w = 0; w < kWidth - 1; ++w) sbox(s[w]);
    }
    sbox(s[kWidth - 1]);
    uint32_t o[kWidth][kLimbs];
#pragma unroll
    for (int row = 0; row < kWidth; ++row) {
      zk::mont_mul<zk::Fr>(o[row], s[0], mds + (row * kWidth) * kLimbs);
#pragma unroll
      for (int col = 1; col < kWidth; ++col) {
        uint32_t p[kLimbs];
        zk::mont_mul<zk::Fr>(p, s[col], mds + (row * kWidth + col) * kLimbs);
        zk::add<zk::Fr>(o[row], o[row], p);
      }
    }
#pragma unroll
    for (int w = 0; w < kWidth; ++w)
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) s[w][j] = o[w][j];
  }

#pragma unroll
  for (int w = 0; w < kWidth; ++w)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
      out[((long long)w * kLimbs + j) * lanes + t] = s[w][j];
}

}  // namespace

extern "C" int zk_hades_permute(const void* state, const void* consts,
                                void* out, long long lanes, void* stream) {
  const unsigned grid = zk::blocks_for(lanes, kHadesThreads);
  hades_kernel<<<grid, kHadesThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)state, (const uint32_t*)consts, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
