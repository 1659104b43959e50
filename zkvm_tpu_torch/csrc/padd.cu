// Complete G1 addition over limb-major [..., 12, B] projective batches.
//
// Replaces zkvm_tpu/ops/pallas_field.py:padd_pallas_2l (kernel
// _padd_kernel -> _padd_vals, multiply _mont_mul_scr2): RCB15 algorithm 7
// (a = 0), outputs fully reduced, so they match the reference bit for bit.
// It also serves every doubling (p == q).  One thread a lane.
//
// Bounded by operations: 12 Fq products a lane, ~3.6k 32-bit multiply-adds.
// A plain kernel (one thread, 14 fully reduced CIOS products with 64-bit
// sums, all six operands loaded up front) needs 194 registers, fits two
// blocks an SM and reaches a quarter of that bound: not multiplier throughput
// but dependent carry chains with too few warps to hide them set the pace.
// The design (arithmetic in fq_lazy.cuh):
//   * the product is operand scanning with the carry in the flag, even and
//     odd columns apart: half the instructions, two chains side by side;
//   * intermediates stay in [0, 2q) (sums feeding a product in [0, 4q)),
//     only X3, Y3, Z3 are reduced to [0, q);
//   * the two products by 3b = 12 are four additions: 12 products, not 14;
//   * operands are fetched when they are needed (x1 and x2 twice, the
//     second time from the cache) and each output is stored when it is done,
//     so that about 110 words are live at the peak and three or four blocks
//     of 128 threads fit an SM;
//   * each of the two points comes with its own group, limb and lane stride
//     (in elements), so the even and odd lanes or the two halves of one
//     tensor are read in place.  Neighbouring threads on stride-2 lanes use
//     half of each sector; the other half is the other operand's.  The
//     output is contiguous.
// Launch bounds: blocks of 128 threads, three an SM (at most 168 registers a
// thread), the fastest of the four combinations measured on an H100.
#include "common.cuh"
#include "fq_lazy.cuh"

namespace {

constexpr int N = zk::Fq::N;
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 3;

struct Strides {
  long long group, limb, lane;
};

// a load the compiler can neither merge with an earlier one nor hoist
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

struct Loader {
  const uint32_t* ptr[6];
  long long limb[2];
  __device__ __forceinline__ void operator()(uint32_t* dst, int k) const {
    const uint32_t* p = ptr[k];
    const long long step = limb[k / 3];
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = load_word(p + i * step);
  }
};

struct Storer {
  uint32_t* ptr[3];
  long long limb;
  __device__ __forceinline__ void operator()(int k, const uint32_t* src) const {
#pragma unroll
    for (int i = 0; i < N; ++i) ptr[k][i * limb] = src[i];
  }
};

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
padd_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
            const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
            const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
            uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
            uint32_t* __restrict__ z3, long long groups, long long lanes,
            Strides sp, Strides sq) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long l = t - g * lanes;
  const long long op = g * sp.group + l * sp.lane;
  const long long oq = g * sq.group + l * sq.lane;
  const long long oo = g * N * lanes + l;
  Loader ld = {{x1 + op, y1 + op, z1 + op, x2 + oq, y2 + oq, z2 + oq},
               {sp.limb, sq.limb}};
  Storer st = {{x3 + oo, y3 + oo, z3 + oo}, lanes};
  zk::lazy::g1_add(ld, st);
}

}  // namespace

// `strides`: group, limb and lane stride of the first point, then of the
// second, in elements.
extern "C" int zk_padd(const void* x1, const void* y1, const void* z1,
                       const void* x2, const void* y2, const void* z2,
                       void* x3, void* y3, void* z3, long long groups,
                       long long lanes, const long long* strides,
                       void* stream) {
  const Strides sp = {strides[0], strides[1], strides[2]};
  const Strides sq = {strides[3], strides[4], strides[5]};
  const unsigned grid = zk::blocks_for(groups * lanes, THREADS);
  padd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, groups, lanes, sp, sq);
  return (int)cudaGetLastError();
}
