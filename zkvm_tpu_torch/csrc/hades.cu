// The Hades permutation (Poseidon, width 5, 8 full + 60 partial rounds,
// S-box x^5, dense 5 x 5 MDS) over a limb-major [5, 8, B] batch of Fr states.
//
// Replaces zkvm_tpu/ops/pallas_field.py:hades_permute_pallas (kernel
// _hades_kernel).  A round adds the round constants, raises words to the
// fifth power and multiplies by the MDS matrix; the state after every round
// is the canonical value, so the result equals the reference's bit for bit.
//
// Bounded by integer multiply throughput (320 bytes a lane against a third
// of a million multiply-adds), and, for a launch too small to fill the card,
// by the latency of one thread's chain of dependent products.  The design
// (arithmetic and its ranges in fr_lazy.cuh):
//   * the product is operand scanning with the carry in the flag, even and
//     odd columns apart: about half the instructions of field.cuh's CIOS;
//   * a row of the MDS step is ONE accumulated Montgomery dot product of five
//     pairs (one reduction word a scanned word, 5 x 64 + 72 limb products)
//     and not five products and four additions (5 x 136): a permutation is
//     8 (15 x 272 + 5 x 784) + 60 (3 x 272 + 5 x 784) = 348,160 32-bit
//     multiply-adds against 2000 x 272 = 544,000 for the same function;
//   * only what a square or the state needs is reduced below r: x^2, x^5,
//     the dot product (two conditional subtractions) and the sum with the
//     round constant;
//   * `hades_kernel`: one thread a lane keeps the 5 x 8 state words in
//     registers for all 68 rounds; a partial round branches past the four
//     unused S-boxes (the round index is uniform).  The constants (68 x 5
//     round constants and the matrix, 11,680 bytes in Montgomery form) are
//     staged into shared memory once a block and read from there by every
//     thread at the same address (a broadcast).  The round loop is not
//     unrolled; the loops over the five words are.
//   * `hades_coop_kernel`, for launches that leave most of the card empty:
//     five threads of one warp share a permutation, one state word each, and
//     exchange through __shfl_sync only.  Each adds its round constant,
//     raises its word (in a partial round only the last word's thread keeps
//     the result: the others' S-box costs instruction slots, not time), reads
//     all five words by 40 shuffles and computes its own MDS row, whose five
//     constants it holds in registers for the whole kernel.  A round is three
//     products and one dot product deep instead of 3 to 15 products and five
//     dot products.  A warp holds six permutations (lanes 30 and 31 repeat
//     two roles and are read by nobody); blocks of one warp spread a small
//     launch over the SMs.  It executes up to 1.7 x the multiply-adds of the
//     one-thread kernel, so `zk_hades_permute` takes it only up to
//     kCoopMaxLanes lanes, the crossover measured on an H100
//     (tools/hades_dispatch.py).
// Launch bounds of the one-thread kernel: blocks of 128 threads, two an SM
// (255 registers, 72 bytes spilled), the fastest of six pairs at 2^18 and at
// 2^22 lanes on an H100; three blocks an SM (168 registers) spill 456 bytes
// and are a seventh slower, four (128 registers) 600 bytes.  The five-thread
// kernel needs 96 registers and spills nothing.
#include "common.cuh"
#include "fr_lazy.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 2;
constexpr long long kCoopMaxLanes = 12288;
constexpr int kCoopThreads = 32;   // one warp a block
constexpr int kCoopPerWarp = 6;    // permutations a warp
constexpr int kWidth = 5;
constexpr int kRounds = 68;
constexpr int kHalfFull = 4;   // full rounds at each end
constexpr int kPartial = 60;
constexpr int kLimbs = zk::Fr::N;
constexpr int kArcWords = kRounds * kWidth * kLimbs;
constexpr int kConstWords = kArcWords + kWidth * kWidth * kLimbs;

__device__ __forceinline__ bool full_round(int r) {
  return r < kHalfFull || r >= kHalfFull + kPartial;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
hades_kernel(const uint32_t* __restrict__ state,
             const uint32_t* __restrict__ consts,
             uint32_t* __restrict__ out, long long lanes) {
  __shared__ uint32_t c[kConstWords];
  for (int i = threadIdx.x; i < kConstWords; i += THREADS) c[i] = consts[i];
  __syncthreads();
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
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
    for (int w = 0; w < kWidth; ++w) {
      uint32_t k[kLimbs];
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) k[j] = arc[w * kLimbs + j];
      zk::frl::add_r(s[w], k);
    }
    if (full_round(r)) {
#pragma unroll
      for (int w = 0; w < kWidth - 1; ++w) zk::frl::sbox(s[w]);
    }
    zk::frl::sbox(s[kWidth - 1]);
    // row `row` of the new state from the old one: the multiplicands are the
    // state's words (canonical), the scanned words the matrix's
    uint32_t o[kWidth][kLimbs];
#pragma unroll
    for (int row = 0; row < kWidth; ++row) {
      uint32_t acc[kLimbs + 1];
      const uint32_t* m = mds + row * kWidth * kLimbs;
      zk::frl::dot<kWidth>(
          acc, [&](int col) { return s[col]; },
          [&](int col, int i) { return m[col * kLimbs + i]; });  // < 3.27 r
      zk::frl::reduce_dot(o[row], acc);
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

__global__ void __launch_bounds__(kCoopThreads)
hades_coop_kernel(const uint32_t* __restrict__ state,
                  const uint32_t* __restrict__ consts,
                  uint32_t* __restrict__ out, long long lanes) {
  // lanes 5g .. 5g + 4 of the warp hold the five words of its permutation g;
  // lanes 30 and 31 repeat words 0 and 1 of permutation 5
  const int lane = threadIdx.x;
  const int group = lane < 30 ? lane / kWidth : kCoopPerWarp - 1;
  const int word = lane < 30 ? lane - group * kWidth : lane - 30;
  const int first = group * kWidth;  // the warp lane that holds word 0
  const long long perm = (long long)blockIdx.x * kCoopPerWarp + group;
  // every lane stays for the shuffles: past the end, walk the last lane again
  const long long t = perm < lanes ? perm : lanes - 1;

  uint32_t s[kLimbs], mrow[kWidth][kLimbs], arc[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    s[j] = state[((long long)word * kLimbs + j) * lanes + t];
    arc[j] = consts[word * kLimbs + j];
  }
#pragma unroll
  for (int col = 0; col < kWidth; ++col)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
      mrow[col][j] = consts[kArcWords + ((word * kWidth) + col) * kLimbs + j];

#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    zk::frl::add_r(s, arc);
    // the next round's constant, fetched a round ahead of its use
    const int next = r + 1 < kRounds ? r + 1 : r;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
      arc[j] = consts[(next * kWidth + word) * kLimbs + j];
    uint32_t x[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) x[j] = s[j];
    zk::frl::sbox(x);
    const bool boxed = full_round(r) || word == kWidth - 1;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) s[j] = boxed ? x[j] : s[j];
    // this thread's row: the multiplicands are its five matrix constants,
    // the scanned words the five state words, read where they live
    uint32_t acc[kLimbs + 1];
    zk::frl::dot<kWidth>(
        acc, [&](int col) { return mrow[col]; },
        [&](int col, int i) {
          return __shfl_sync(0xffffffffu, s[i], first + col);
        });  // < 3.27 r
    zk::frl::reduce_dot(s, acc);
  }

  if (perm >= lanes || lane >= 30) return;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j)
    out[((long long)word * kLimbs + j) * lanes + t] = s[j];
}

}  // namespace

extern "C" int zk_hades_permute(const void* state, const void* consts,
                                void* out, long long lanes, void* stream) {
  const uint32_t* ps = (const uint32_t*)state;
  const uint32_t* pc = (const uint32_t*)consts;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes <= kCoopMaxLanes) {
    const unsigned grid = zk::blocks_for(lanes, kCoopPerWarp);
    hades_coop_kernel<<<grid, kCoopThreads, 0, st>>>(ps, pc, (uint32_t*)out,
                                                     lanes);
  } else {
    const unsigned grid = zk::blocks_for(lanes, THREADS);
    hades_kernel<<<grid, THREADS, 0, st>>>(ps, pc, (uint32_t*)out, lanes);
  }
  return (int)cudaGetLastError();
}
