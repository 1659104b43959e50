// The leaf reductions of the matmul NTT over Fr.
//
//   carry_fold: [68, B] int32 byte columns -> [8, B] limbs mod r.  Replaces
//     zkvm_tpu/ops/ntt_mxu.py:_carry_fold_pallas (kernel _carry_fold_kernel).
//     Column t of a lane holds the sum of the byte products of weight 2^(8t)
//     (each below 2^24 from the matmul, at most 32 of them added, so below
//     2^29 and non-negative).  The byte carry runs through registers -- four
//     columns make one 32-bit word -- and the 17 carried words go straight
//     into the split-fold, so the column tensor is read once and nothing
//     else is written: bounded by memory.
//   fold: [17, B] carried 32-bit words -> [8, B] limbs mod r.  Replaces
//     zkvm_tpu/ops/ntt_mxu.py:_fold_pallas (kernel _fold_kernel), the second
//     half of the unfused reduction (its first half, the carry, stays a
//     tensor scan).
//
// The split-fold of a 17-word value v = lo + 2^256 mid + 2^512 hi (lo, mid
// of 8 words, hi of one) is ONE Montgomery dot product on fr_lazy.cuh's
// carry chains, t = (K1 mid + K2 hi) / R mod r with K1 = 2^256 R mod r and
// K2 = 2^512 R mod r, plus lo mod r:
//   * `dot<2, 1>` takes K1 and K2 as its multiplicands and scans mid and
//     hi, whose words may be anything; hi is one word, which row 0 alone
//     takes (the other rows would add products by zero).  t < (K1 mid + K2
//     hi) / R + r < K1 + 2^31 + r < 2 r (fr_lazy.cuh's ranges), which
//     `reduce_dot` makes canonical;
//   * lo < 2^256 < 2.21 r: two conditional subtractions (`reduce_words`);
//   * the sum of the two canonical values, once reduced (`add_r`).
// The output is the canonical value of v mod r, which is unique: bit for bit
// the reference's `_fold_body`.  The dot product is 8 x 8 + 8 limb products
// and 72 of the reduction, 288 32-bit multiply-adds with their high halves
// (`kernels.fold_multiply_adds`), and one reduction.
//
// One thread per lane; row k of lane b sits at k * B + b, so a warp's loads
// of one row are contiguous.  fold runs 128 threads a block: 65,536 lanes
// are 512 blocks, about four an SM.
#include "common.cuh"
#include "fr_lazy.cuh"

namespace {

constexpr int N = zk::Fr::N;
constexpr int kColumns = 68;          // byte columns of one product
constexpr int kWords = kColumns / 4;  // 17 carried words
constexpr int kFoldThreads = 128;

// r = v mod r, canonical, for the 17 words v = lo + 2^256 mid + 2^512 hi.
__device__ __forceinline__ void split_fold(uint32_t* r, const uint32_t* v) {
  uint32_t c1[N], c2[N], t[N + 1], lo[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c1[i] = zk::Fr::k1(i);  // 2^256 R mod r
    c2[i] = zk::Fr::k2(i);  // 2^512 R mod r
    lo[i] = v[i];
  }
  // hi is one word: row 0 alone takes it
  zk::frl::dot<2, 1>(
      t, [&](int j) { return j ? c2 : c1; },
      [&](int j, int i) { return j ? v[2 * N] : v[N + i]; });
  zk::frl::reduce_dot(r, t);   // (K1 mid + K2 hi) / R mod r
  zk::frl::reduce_words(lo);   // lo mod r
  zk::frl::add_r(r, lo);
}

__global__ void carry_fold_kernel(const int32_t* __restrict__ d,
                                  uint32_t* __restrict__ out,
                                  long long lanes) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  uint32_t v[kWords];
  int32_t carry = 0;  // arithmetic shifts, as the reference's s32 columns
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t c = d[(4 * w + k) * lanes + b] + carry;
      word |= (uint32_t)(c & 0xFF) << (8 * k);
      carry = c >> 8;
    }
    v[w] = word;
  }
  uint32_t r[N];
  split_fold(r, v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i * lanes + b] = r[i];
}

__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const uint32_t* __restrict__ limbs, uint32_t* __restrict__ out,
            long long lanes) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  uint32_t v[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) v[w] = limbs[w * lanes + b];
  uint32_t r[N];
  split_fold(r, v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i * lanes + b] = r[i];
}

}  // namespace

// Both return cudaGetLastError().
extern "C" int zk_carry_fold(const void* d, void* out, long long lanes,
                             void* stream) {
  const unsigned grid = zk::blocks_for(lanes, zk::kThreads);
  carry_fold_kernel<<<grid, zk::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int zk_fold(const void* limbs, void* out, long long lanes,
                       void* stream) {
  const unsigned grid = zk::blocks_for(lanes, kFoldThreads);
  fold_kernel<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)limbs, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
