// Complete G1 addition, grouped: the same function as padd.cu, its 14 Fq
// products run as three groups of 6 + 2 + 6 independent ones.
//
// Replaces zkvm_tpu/ops/pallas_field.py:padd_pallas_ilp and padd_pallas_ilp2l
// (kernel _padd_kernel_ilp; multiplies _mont_mul_scr_m / _mont_mul_scr_m2).
// The reference stacks a group's independent products on one array axis so
// that a single multiply chain serves them all.  On this card independent
// products side by side are cooperating threads: TWO threads a point, each
// taking 3 + 1 + 3 of the 6 + 2 + 6 products, so a thread holds about half
// of padd.cu's live words and a point's products run on two lanes at once.
// The reference's two-limb variant differs only in 16-bit multiply
// bookkeeping, which 32-bit limbs with 64-bit products subsume: this one
// kernel serves both.
//
// Both threads of a pair run the SAME code (no divergent branch):
// the half h = lane & 1 only selects operands.  With RCB15 algorithm 7
// (a = 0) in the reference's names:
//
//   stage 1   h = 0: t0 = x1 x2      t1 = y1 y2            t3' = (x1+y1)(x2+y2)
//             h = 1: t2 = z1 z2      t4' = (y1+z1)(y2+z2)  t5' = (x1+z1)(x2+z2)
//     exchange t0 <-> t2, and t1 -> h = 1
//             h = 0: t3 = t3' - t0 - t1
//             h = 1: t5 = t5' - t0 - t2,  t4 = t4' - t1 - t2
//   stage 2   h = 0: t6 = 3b t2      h = 1: y3 = 3b t5
//             h = 0: z3 = t1 + t6, t1 = t1 - t6;  both: t03 = 3 t0
//     exchange z3 -> h = 1
//   stage 3   h = 0: u1 = t3 t1     u3 = t1 z3      u6 = t03 t3
//             h = 1: u2 = t4 y3     u4 = y3 t03     u5 = z3 t4
//     exchange u1 <-> u2, u3 <-> u4, u6 <-> u5
//             h = 0: X3 = u1 - u2, Y3 = u3 + u4;  h = 1: Z3 = u5 + u6
//
// Every add, sub and product is fully reduced, so the outputs equal
// padd.cu's bit for bit.  Words cross between the two threads through
// __shfl_xor_sync (72 a thread).  Bounded by integer multiply throughput,
// like padd.cu; both threads read all six operands (the second read hits
// the cache), which the byte bound does not count.
#include "common.cuh"
#include "field.cuh"

namespace {

constexpr int kThreadsIlp = 128;  // 64 points a block
constexpr int N = zk::Fq::N;
using F = zk::Fq;

__device__ __forceinline__ void load(uint32_t* dst, const uint32_t* src,
                                     long long base, long long lanes) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[base + i * lanes];
}

__device__ __forceinline__ void store(uint32_t* dst, const uint32_t* src,
                                      long long base, long long lanes) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[base + i * lanes] = src[i];
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

__global__ void __launch_bounds__(kThreadsIlp)
padd_ilp_kernel(const uint32_t* __restrict__ x1p,
                const uint32_t* __restrict__ y1p,
                const uint32_t* __restrict__ z1p,
                const uint32_t* __restrict__ x2p,
                const uint32_t* __restrict__ y2p,
                const uint32_t* __restrict__ z2p,
                uint32_t* __restrict__ x3p, uint32_t* __restrict__ y3p,
                uint32_t* __restrict__ z3p, long long groups,
                long long lanes) {
  const long long t = (long long)blockIdx.x * kThreadsIlp + threadIdx.x;
  const long long total = groups * lanes;
  const bool h = (t & 1) != 0;
  // a thread past the end redoes the last point and stores nothing: every
  // lane of the warp must reach the shuffles
  const bool live = (t >> 1) < total;
  const long long pt = live ? (t >> 1) : total - 1;
  const long long g = pt / lanes;
  const long long base = g * N * lanes + (pt - g * lanes);

  uint32_t m0[N], m1[N], m2[N], r0[N], r1[N];
  {
    uint32_t x1[N], y1[N], z1[N], x2[N], y2[N], z2[N], a[N], b[N];
    load(x1, x1p, base, lanes);
    load(y1, y1p, base, lanes);
    load(z1, z1p, base, lanes);
    load(x2, x2p, base, lanes);
    load(y2, y2p, base, lanes);
    load(z2, z2p, base, lanes);
    // m0 = t0 | t2
    pick(a, h, z1, x1);
    pick(b, h, z2, x2);
    zk::mont_mul<F>(m0, a, b);
    // m2 = (x1 + y1)(x2 + y2) | (x1 + z1)(x2 + z2)
    pick(a, h, z1, y1);
    pick(b, h, z2, y2);
    zk::add<F>(a, a, x1);
    zk::add<F>(b, b, x2);
    zk::mont_mul<F>(m2, a, b);
    // m1 = y1 y2 | (y1 + z1)(y2 + z2): h = 0 adds zero
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a[i] = h ? z1[i] : 0u;
      b[i] = h ? z2[i] : 0u;
    }
    zk::add<F>(a, a, y1);
    zk::add<F>(b, b, y2);
    zk::mont_mul<F>(m1, a, b);
  }
  partner(r0, m0);  // h = 0 receives t2, h = 1 receives t0
  partner(r1, m1);  // h = 1 receives t1
  // m2 = t3 | t5
  {
    uint32_t a[N];
    pick(a, h, r0, m0);  // t0
    zk::sub<F>(m2, m2, a);
    pick(a, h, m0, m1);  // t1 | t2
    zk::sub<F>(m2, m2, a);
  }
  // h = 1: t4 = t4' - t1 - t2 (h = 0 computes a value it never uses)
  uint32_t t4[N];
  zk::sub<F>(t4, m1, r1);
  zk::sub<F>(t4, t4, m0);

  // stage 2: n = 3b t2 | 3b t5
  uint32_t n[N], t03[N];
  {
    uint32_t a[N], b3[N];
#pragma unroll
    for (int i = 0; i < N; ++i) b3[i] = F::b3(i);
    pick(a, h, m2, r0);
    zk::mont_mul<F>(n, a, b3);
    pick(a, h, r0, m0);  // t0
    zk::add<F>(t03, a, a);
    zk::add<F>(t03, t03, a);
  }
  // h = 0: z3 = t1 + t6, t1 = t1 - t6
  uint32_t z3[N], t1[N], z3r[N];
  zk::add<F>(z3, m1, n);
  zk::sub<F>(t1, m1, n);
  partner(z3r, z3);  // h = 1 receives z3

  // stage 3: A = P Q, B = Q R, C = S P with
  //   P = t3 | t4, Q = t1 | y3, R = z3 | t03, S = t03 | z3
  uint32_t pa[N], pb[N], pc[N];
  {
    uint32_t p[N], q[N], o[N];
    pick(p, h, t4, m2);
    pick(q, h, n, t1);
    zk::mont_mul<F>(pa, p, q);  // u1 | u2
    pick(o, h, t03, z3);
    zk::mont_mul<F>(pb, q, o);  // u3 | u4
    pick(o, h, z3r, t03);
    zk::mont_mul<F>(pc, o, p);  // u6 | u5
  }
  uint32_t ra[N], rb[N], rc[N];
  partner(ra, pa);
  partner(rb, pb);
  partner(rc, pc);
  // h = 0: X3 = u1 - u2 and Y3 = u3 + u4;  h = 1: Z3 = u5 + u6
  uint32_t x3[N], s[N];
  zk::sub<F>(x3, pa, ra);
  pick(pb, h, pc, pb);
  pick(rb, h, rc, rb);
  zk::add<F>(s, pb, rb);
  if (!live) return;
  if (!h) store(x3p, x3, base, lanes);
  store(h ? z3p : y3p, s, base, lanes);
}

}  // namespace

extern "C" int zk_padd_ilp(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* x3, void* y3, void* z3, long long groups,
                           long long lanes, void* stream) {
  const unsigned grid = zk::blocks_for(2 * groups * lanes, kThreadsIlp);
  padd_ilp_kernel<<<grid, kThreadsIlp, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, groups, lanes);
  return (int)cudaGetLastError();
}
