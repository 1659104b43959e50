// Fold per-window MSM sums into one point per set:
//   total_s = sum_w 2^(c w) S_{s,w}
// by Horner's rule, highest window first (c doublings and one addition per
// window), in one launch.
//
// Replaces zkvm_tpu/ops/pallas_field.py:window_fold_pallas (kernel
// _window_fold_kernel), whose oracle is msm._host_window_fold.  Doublings
// are the complete addition with p == q, as on the TPU, so the projective
// coordinates are the reference's bit for bit.  Input rows are [S * W, 12, 1]
// (set-major), output [3, 12, S].
//
// This is a latency kernel.  Its bound by operations (W (c + 1) additions a
// set) sees no chain, but the chain is the algorithm's: the top window needs
// its c (W - 1) doublings however the sum is bracketed, so W (c + 1) = 288
// dependent additions at 2^16, and the time to win is the latency of ONE
// addition (walked in one thread, 14 products deep, ~52 us).  The design
// (arithmetic in fq_lazy.cuh):
//   * one block of one warp a set, so that every set has an SM's
//     schedulers to itself (S blocks, any S);
//   * the addition's 6 + 6 independent products run side by side on six
//     lanes that exchange words by __shfl_sync only (`g1_add_coop`): an
//     addition is two products deep; the two products by 3b are additions;
//   * the product is the carry-flag multiply, nothing is reduced below 2q
//     before the store.
// The four 8-lane groups of the warp run the same set; lane 0 stores.
//
// `zk_fq_chain` measures what that design cannot go below: the latency of
// one dependent Fq product in one thread.
#include "common.cuh"
#include "fq_lazy.cuh"

namespace {

constexpr int N = zk::Fq::N;
constexpr int kFoldThreads = 32;

__global__ void __launch_bounds__(kFoldThreads)
window_fold_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
                   int c, int w_count, int n_sets) {
  const int s = blockIdx.x;
  const int role = threadIdx.x & 7;
  uint32_t ax[N], ay[N], az[N], rx[N], ry[N], rz[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ax[i] = 0;
    ay[i] = zk::Fq::one(i);
    az[i] = 0;
  }
#pragma unroll 1
  for (int w = w_count - 1; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < c; ++k)
      zk::lazy::g1_add_coop(ax, ay, az, ax, ay, az, role);
    const long long base = ((long long)s * w_count + w) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      rx[i] = x[base + i];
      ry[i] = y[base + i];
      rz[i] = z[base + i];
    }
    zk::lazy::g1_add_coop(ax, ay, az, rx, ry, rz, role);
  }
  zk::lazy::reduce_q(ax);
  zk::lazy::reduce_q(ay);
  zk::lazy::reduce_q(az);
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[(0 * N + i) * n_sets + s] = ax[i];
    out[(1 * N + i) * n_sets + s] = ay[i];
    out[(2 * N + i) * n_sets + s] = az[i];
  }
}

// x <- x a / 2^384, `iters` times, one warp, a lane a value: the fully
// reduced CIOS product of field.cuh (mode 0) or the carry-flag product
// (mode 1; x stays below 2q and is reduced at the store).
__global__ void __launch_bounds__(32)
fq_chain_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                int iters, int mode) {
  const int lane = threadIdx.x;
  uint32_t v[N], acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = v[i] = a[i * 32 + lane];
  if (mode == 0) {
#pragma unroll 1
    for (int k = 0; k < iters; ++k) zk::mont_mul<zk::Fq>(acc, acc, v);
  } else {
#pragma unroll 1
    for (int k = 0; k < iters; ++k) zk::lazy::mul(acc, acc, v);
    zk::lazy::reduce_q(acc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i * 32 + lane] = acc[i];
}

}  // namespace

extern "C" int zk_window_fold(const void* x, const void* y, const void* z,
                              void* out, int c, int w_count, int n_sets,
                              void* stream) {
  window_fold_kernel<<<n_sets, kFoldThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)out, c, w_count, n_sets);
  return (int)cudaGetLastError();
}

// a, out: [12, 32] words, limb-major
extern "C" int zk_fq_chain(const void* a, void* out, int iters, int mode,
                           void* stream) {
  fq_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, iters, mode);
  return (int)cudaGetLastError();
}
