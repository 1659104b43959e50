// Fold per-window MSM sums into one point per set:
//   total_s = sum_w 2^(c w) S_{s,w}
// by Horner's rule, highest window first (c doublings and one addition per
// window), in one launch.
//
// Replaces zkvm_tpu/ops/pallas_field.py:window_fold_pallas (kernel
// _window_fold_kernel), whose oracle is msm._host_window_fold.  One thread
// per set walks the whole chain in registers; doublings are the complete
// addition with p == q, as on the TPU.  This is a latency kernel: the grid
// is a single block (a handful of sets), the chain is W (c + 1) dependent
// G1 additions (24 * 12 = 288 at 2^16), and nothing else runs on the card
// meanwhile.  Input rows are [S * W, 12, 1] (set-major), output [3, 12, S].
#include "common.cuh"
#include "field.cuh"

namespace {

constexpr int kFoldThreads = 32;

__global__ void window_fold_kernel(const uint32_t* __restrict__ x,
                                   const uint32_t* __restrict__ y,
                                   const uint32_t* __restrict__ z,
                                   uint32_t* __restrict__ out, int c,
                                   int w_count, int n_sets) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_sets) return;
  constexpr int N = zk::Fq::N;
  zk::G1 acc, row;
  zk::g1_identity(acc);
  for (int w = w_count - 1; w >= 0; --w) {
    for (int k = 0; k < c; ++k) zk::g1_add(acc, acc, acc);
    const long long base = ((long long)s * w_count + w) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      row.x[i] = x[base + i];
      row.y[i] = y[base + i];
      row.z[i] = z[base + i];
    }
    zk::g1_add(acc, acc, row);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[(0 * N + i) * n_sets + s] = acc.x[i];
    out[(1 * N + i) * n_sets + s] = acc.y[i];
    out[(2 * N + i) * n_sets + s] = acc.z[i];
  }
}

}  // namespace

extern "C" int zk_window_fold(const void* x, const void* y, const void* z,
                              void* out, int c, int w_count, int n_sets,
                              void* stream) {
  const unsigned grid = zk::blocks_for(n_sets, kFoldThreads);
  window_fold_kernel<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)out, c, w_count, n_sets);
  return (int)cudaGetLastError();
}
