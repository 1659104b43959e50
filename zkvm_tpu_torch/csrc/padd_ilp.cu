// Complete G1 addition, two threads a point: the same function as padd.cu,
// its twelve Fq products split six and six.
//
// Replaces zkvm_tpu/ops/pallas_field.py:padd_pallas_ilp and padd_pallas_ilp2l
// (kernel _padd_kernel_ilp; multiplies _mont_mul_scr_m / _mont_mul_scr_m2).
// The reference stacks a group's independent products on one array axis so
// that a single multiply chain serves them all; its two-limb variant differs
// only in 16-bit multiply bookkeeping, which 32-bit limbs subsume, so this
// one kernel serves both.  On this card independent products side by side
// are cooperating threads.  Bounded, like padd.cu, by integer multiply
// throughput, so the design is padd.cu's arithmetic (fq_lazy.cuh: the
// carry-flag product, values kept in [0, 2q), the two products by 3b as
// four additions each) split over the two threads of a pair, the split of
// `g1_add_coop`'s role table narrowed to two lanes.  Both threads run the
// SAME code (no divergent branch): the half h = lane & 1 only selects
// operands and pointers.  With RCB15 algorithm 7 (a = 0) in the
// reference's names:
//
//   stage 1   h = 0: t0 = x1 x2   t1 = y1 y2              t3' = (x1+y1)(x2+y2)
//             h = 1: t2 = z1 z2   t4' = (y1+z1)(y2+z2)    t5' = (x1+z1)(x2+z2)
//     exchange all three (36 words): both threads hold the six products
//     and both compute t3, t4, t5, t6 = 12 t2, y3 = 12 t5, z3 = t1 + t6,
//     t1 - t6 and 3 t0 (additions, which the multiplier's pace hides)
//   stage 2   h = 0: (t1 - t6) z3      t3 (t1 - t6)      t4 y3
//             h = 1: y3 3t0            z3 t4             3t0 t3
//     the first products are exchanged (12 words): both threads hold
//     Y3 = (t1 - t6) z3 + y3 3t0 and store half of its limbs each;
//     h = 0 keeps X3 = t3 (t1 - t6) - t4 y3, h = 1 Z3 = z3 t4 + 3t0 t3.
//
// 48 __shfl_xor_sync a thread (72 before); the outputs are reduced to
// [0, q) at the store, so they equal padd.cu's bit for bit.  Both threads
// read all six operands (the partner's read of the same word is the same
// transaction).  Each point comes with its group, limb and lane strides,
// as in padd.cu; the output is contiguous.
#include "common.cuh"
#include "fq_lazy.cuh"

namespace {

constexpr int N = zk::Fq::N;
constexpr int THREADS = 128;  // 64 points a block
constexpr int BLOCKS_PER_SM = 3;

struct Strides {
  long long group, limb, lane;
};

__device__ __forceinline__ void load(uint32_t* dst, const uint32_t* src,
                                     long long step) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[i * step];
}

// r = h ? a : b
__device__ __forceinline__ void pick(uint32_t* r, bool h, const uint32_t* a,
                                     const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = h ? a[i] : b[i];
}

// r = the partner thread's s
__device__ __forceinline__ void partner(uint32_t* r, const uint32_t* s) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = __shfl_xor_sync(0xffffffffu, s[i], 1);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
padd_ilp_kernel(const uint32_t* __restrict__ x1p,
                const uint32_t* __restrict__ y1p,
                const uint32_t* __restrict__ z1p,
                const uint32_t* __restrict__ x2p,
                const uint32_t* __restrict__ y2p,
                const uint32_t* __restrict__ z2p,
                uint32_t* __restrict__ x3p, uint32_t* __restrict__ y3p,
                uint32_t* __restrict__ z3p, long long groups, long long lanes,
                Strides sp, Strides sq) {
  using namespace zk::lazy;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long total = groups * lanes;
  const bool h = (t & 1) != 0;
  // a thread past the end redoes the last point and stores nothing: every
  // lane of the warp must reach the shuffles
  const bool live = (t >> 1) < total;
  const long long pt = live ? (t >> 1) : total - 1;
  const long long g = pt / lanes;
  const long long l = pt - g * lanes;
  const long long op = g * sp.group + l * sp.lane;
  const long long oq = g * sq.group + l * sq.lane;
  const long long oo = g * N * lanes + l;

  // stage 1: m0 = t0 | t2, m1 = t1 | t4', m2 = t3' | t5'; coordinates in
  // [0, 2q)
  uint32_t m0[N], m1[N], m2[N];
  {
    uint32_t a[N], b[N], c[N], d[N];
    load(a, (h ? z1p : x1p) + op, sp.limb);
    load(b, (h ? z2p : x2p) + oq, sq.limb);
    mul(m0, a, b);   // x1 x2 | z1 z2 < 1.41q
    load(c, (h ? x1p : y1p) + op, sp.limb);
    load(d, (h ? x2p : y2p) + oq, sq.limb);
    add12(a, c);     // x1 + y1 | z1 + x1 < 4q
    add12(b, d);     // x2 + y2 | z2 + x2 < 4q
    mul(m2, a, b);   // < 2.63q
    fold_2q(m2);
    load(a, y1p + op, sp.limb);
    load(b, y2p + oq, sq.limb);
    load(c, z1p + op, sp.limb);
    load(d, z2p + oq, sq.limb);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      c[i] = h ? c[i] : 0u;
      d[i] = h ? d[i] : 0u;
    }
    add12(a, c);     // y1 | y1 + z1 < 4q
    add12(b, d);     // y2 | y2 + z2 < 4q
    mul(m1, a, b);   // < 2.63q
    fold_2q(m1);
  }
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N], t5[N];
  {
    uint32_t r[N];
    partner(r, m0);
    pick(t0, h, r, m0);
    pick(t2, h, m0, r);
    partner(r, m1);
    pick(t1, h, r, m1);
    pick(t4, h, m1, r);
    partner(r, m2);
    pick(t3, h, r, m2);
    pick(t5, h, m2, r);
  }
  sub2q(t3, t0);
  sub2q(t3, t1);            // t3 = x1 y2 + x2 y1
  sub2q(t4, t1);
  sub2q(t4, t2);            // t4 = y1 z2 + y2 z1
  sub2q(t5, t0);
  sub2q(t5, t2);            // t5 = x1 z2 + x2 z1
  uint32_t z3[N], u[N], v[N];
  times_3_12(u, t2, t2);    // t2 = t6 = 3b t2
  copy(z3, t1);
  add2q(z3, t2);            // z3 = t1 + t6
  sub2q(t1, t2);            // t1 = t1 - t6
  times_3_12(u, t5, t5);    // t5 = y3 = 3b t5
  times_3_12(t0, u, t0);    // t0 = 3 t0
  // stage 2, every operand in [0, 2q): products < 1.41q
  {
    uint32_t a[N], b[N];
    pick(a, h, t5, t1);
    pick(b, h, t0, z3);
    mul(u, a, b);           // (t1 - t6) z3 | y3 3t0
    partner(v, u);
    add2q(u, v);
    reduce_q(u);            // Y3, on both threads
  }
  if (!live) return;
  // each thread stores six limbs of Y3: h = 0 the low, h = 1 the high
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    y3p[oo + (i + (h ? N / 2 : 0)) * lanes] = h ? u[i + N / 2] : u[i];
  {
    uint32_t a[N], b[N];
    pick(a, h, z3, t3);
    pick(b, h, t4, t1);
    mul(u, a, b);           // t3 (t1 - t6) | z3 t4
    pick(a, h, t0, t4);
    pick(b, h, t3, t5);
    mul(v, a, b);           // t4 y3 | 3t0 t3
  }
  copy(t1, u);
  sub2q(t1, v);             // X3
  add2q(u, v);              // Z3
  pick(u, h, u, t1);
  reduce_q(u);
  uint32_t* out = (h ? z3p : x3p) + oo;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i * lanes] = u[i];
}

}  // namespace

// `strides`: group, limb and lane stride of the first point, then of the
// second, in elements.
extern "C" int zk_padd_ilp(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* x3, void* y3, void* z3, long long groups,
                           long long lanes, const long long* strides,
                           void* stream) {
  const Strides sp = {strides[0], strides[1], strides[2]};
  const Strides sq = {strides[3], strides[4], strides[5]};
  const unsigned grid = zk::blocks_for(2 * groups * lanes, THREADS);
  padd_ilp_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, groups, lanes, sp, sq);
  return (int)cudaGetLastError();
}
