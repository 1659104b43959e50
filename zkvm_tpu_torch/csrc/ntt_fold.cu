// The leaf reductions of the matmul NTT over Fr.
//
//   carry_fold: [68, B] int32 byte columns -> [8, B] limbs mod r.  Replaces
//     zkvm_tpu/ops/ntt_mxu.py:_carry_fold_pallas (kernel _carry_fold_kernel).
//     Column t of a lane holds the sum of the byte products of weight 2^(8t)
//     (each below 2^24 from the matmul, at most 32 of them added, so below
//     2^29 and non-negative).  The byte carry runs through registers -- four
//     columns make one 32-bit word -- and the 17 carried words go straight
//     into the split-fold, so the column tensor is read once and nothing
//     else is written.  304 bytes per lane for 2 * 64 + 16 limb products:
//     bounded by memory.
//   fold: [17, B] carried 32-bit words -> [8, B] limbs mod r.  Replaces
//     zkvm_tpu/ops/ntt_mxu.py:_fold_pallas (kernel _fold_kernel), the second
//     half of the unfused reduction (its first half, the carry, stays a
//     tensor scan).
//
// One thread per lane; row k of lane b sits at k * B + b, so a warp's loads
// of one row are contiguous.
#include "common.cuh"
#include "field.cuh"

namespace {

constexpr int kColumns = 68;          // byte columns of one product
constexpr int kWords = kColumns / 4;  // 17 carried words

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
  uint32_t r[zk::Fr::N];
  zk::split_fold(r, v);
#pragma unroll
  for (int i = 0; i < zk::Fr::N; ++i) out[i * lanes + b] = r[i];
}

__global__ void fold_kernel(const uint32_t* __restrict__ limbs,
                            uint32_t* __restrict__ out, long long lanes) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  uint32_t v[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) v[w] = limbs[w * lanes + b];
  uint32_t r[zk::Fr::N];
  zk::split_fold(r, v);
#pragma unroll
  for (int i = 0; i < zk::Fr::N; ++i) out[i * lanes + b] = r[i];
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
  const unsigned grid = zk::blocks_for(lanes, zk::kThreads);
  fold_kernel<<<grid, zk::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)limbs, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
