// The MSM's bucket-sorted points, gathered, signed and parked, with the first
// level of the halving tree added on the way.
//
// A kernel of the port alone, with no TPU counterpart: on the TPU,
// zkvm_tpu/ops/msm.py's `_gather_points` (a row gather of the point-major
// matrix, the y negation, the parking selects) and the first `_tree_level`'s
// selects are XLA operations before and after `padd_pallas_2l`, which no
// Pallas kernel holds.  Here they were PyTorch calls that wrote the
// sorted points at full width ([B, 36, N] words: a row gather, a negation
// launch, three strided selects), read them back through `padd` on every
// second lane and selected again.  This kernel writes only what the next
// stage reads.
//
// Inputs, of one sort per digit row (`ops/msm.py` `_sort_digits`): sid [B, N]
// ascending bucket ids (dead lanes, a digit 0 or the point at infinity, carry
// a sentinel above `half`), neg [B, N] sign flags, perm [B, N] point indices
// into the point-major matrix pm [rows, 36] (x | y | z, Montgomery, each
// below q).  The point of sorted lane i is pm[perm[b, i]] with y negated where
// neg[b, i] is set, or the identity (0 : 1 : 0) where sid[b, i] > half.
//
//   * merge mode (`rsid` given, K = N / 2): thread j of row b takes the
//     sorted lanes 2j and 2j + 1 and writes their sum where they share a
//     bucket, else the right one, and rsid[b, j] = half + 1 where they merged,
//     else sid[b, 2j] (the left lane's bucket, which the caller compacts into
//     the level's rejects);
//   * gather mode: out[b, :, k] is the point of sorted lane src[b, k] (of lane
//     k where `src` is null), the identity where sid[b, k] > half (here sid
//     is [B, K], the output lanes' buckets).
// Outputs x, y, z [B, 12, K], limb-major and contiguous, each canonical: the
// limbs of `kernels.msm_gather_plain` (the PyTorch composition it replaces),
// bit for bit.
//
// Every live row of pm is affine: z = 1 (the points of `MSMContext`, which
// `g1_ops.affine_to_device` encodes from `G1Affine`); a row at infinity has
// z = 0 and is dead through the caller's infinity flags, so it never enters
// an addition.
//
// Bounded by operations: a merge is a complete G1 addition of two affine
// points, `fq_lazy.cuh`'s `g1_add` with z1 = z2 = 1 (`g1_add_affine`: t2 =
// z1 z2 = 1, t4 = y1 + y2 and t5 = x1 + x2 in place of three products), 9
// Fq products and the same canonical outputs as `padd`.  The gather is L2
// traffic (pm holds 144 bytes a point, a few MB for the commit key of a
// proof), x and y of a row read as six 16-byte loads where the addition
// needs them; the only device-memory traffic is the sort's outputs (13
// bytes a lane) and the output (144 bytes a point).  So the design is
// `padd`'s: one thread a lane, 128 x 3 launch bounds.  Two dead lanes write
// the identity without arithmetic (padd of two identities is (0 : 1 : 0));
// the dead lanes sort last, so whole warps skip.
#include "common.cuh"
#include "fq_lazy.cuh"

namespace {

constexpr int N = zk::Fq::N;
constexpr int ROW = 3 * N;  // words of a point-major row
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 3;

using zk::lazy::add12;
using zk::lazy::add2q;
using zk::lazy::copy;
using zk::lazy::fold_2q;
using zk::lazy::mul;
using zk::lazy::reduce_q;
using zk::lazy::sub12;
using zk::lazy::sub2q;
using zk::lazy::times_3_12;

// 3b = 12 in Montgomery form (12 R mod q)
__device__ __forceinline__ uint32_t twelve(int i) {
  constexpr uint32_t v[N] = {0x0027552e, 0x44760000, 0x43480020, 0xdcb8009a,
                             0x4a6e8b59, 0x6f7ee9ce, 0xc0a95bc6, 0xb10330b7,
                             0xfb1e54b7, 0x6140b1fc, 0x7f0bb4e1, 0x0381be09};
  return v[i];
}

struct Args {
  const uint32_t* pm;
  const int32_t* sid;
  const uint8_t* neg;
  const long long* perm;
  const int32_t* src;
  uint32_t* out[3];
  int32_t* rsid;
  long long groups, lanes, n;
  int half;
};

// twelve words of a point-major row, three 16-byte loads through the
// read-only path, where they are needed (the compiler may not hoist them)
__device__ __forceinline__ void load12(uint32_t* d, const uint32_t* p) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d[4 * q]), "=r"(d[4 * q + 1]), "=r"(d[4 * q + 2]),
                   "=r"(d[4 * q + 3])
                 : "l"(p + 4 * q));
}

// y -> q - y where `neg` is set: y in [0, q) gives (0, q], a value of the
// lazy arithmetic's range [0, 2q)
__device__ __forceinline__ void negate_if(uint32_t* y, bool neg) {
  uint32_t t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = zk::Fq::p(i);
  sub12(t, y);  // no borrow: y < q
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = neg ? t[i] : y[i];
}

struct Point {
  const uint32_t* row;
  bool neg, dead;
};

// sorted lane j (an offset into the [B, N] inputs) as a point; a dead lane
// reads nothing of perm or neg
__device__ __forceinline__ Point point_at(const Args& a, long long j,
                                          bool dead) {
  if (dead) return {a.pm, false, true};
  return {a.pm + a.perm[j] * ROW, a.neg[j] != 0, false};
}

// coordinate k of the pair (0, 1: x1 y1 of the left point, 3, 4: x2 y2 of
// the right), y signed; both points live
struct PairLoader {
  Point p[2];
  __device__ __forceinline__ void operator()(uint32_t* dst, int k) const {
    const Point& s = p[k / 3];
    const int c = k % 3;
    load12(dst, s.row + c * N);
    if (c == 1) negate_if(dst, s.neg);
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

// the point itself, canonical: the identity where dead, y reduced after a
// negation (q - 0 = q)
__device__ __forceinline__ void store_point(const Point& s, const Storer& st) {
  uint32_t v[N];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (s.dead) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = c == 1 ? zk::Fq::one(i) : 0u;
    } else {
      load12(v, s.row + c * N);
      if (c == 1) {
        negate_if(v, s.neg);
        reduce_q(v);
      }
    }
    st(c, v);
  }
}

// (x3, y3, z3) = P + Q for z1 = z2 = 1 by fq_lazy.cuh's `g1_add` with
// t2 = z1 z2 = 1, so t6 = 3b t2 = 12, t4 = (y1 + z1)(y2 + z2) - t1 - t2 =
// y1 + y2 and t5 = x1 + x2: the same residues, the same canonical outputs,
// 9 products.  `ld` fetches x1 y1 | x2 y2 (k = 0, 1 | 3, 4), each in [0, 2q).
template <class Load, class Store>
__device__ __forceinline__ void g1_add_affine(Load ld, Store st) {
  uint32_t t0[N], t1[N], t3[N], t4[N], t5[N];
  {
    uint32_t a[N], b[N], c[N], d[N];
    ld(a, 0);
    ld(b, 3);
    mul(t0, a, b);  // x1 x2 < 1.41q
    copy(t5, a);
    add2q(t5, b);   // t5 = x1 + x2
    ld(c, 1);
    ld(d, 4);
    mul(t1, c, d);  // y1 y2 < 1.41q
    copy(t4, c);
    add2q(t4, d);   // t4 = y1 + y2
    add12(a, c);    // x1 + y1 < 4q
    add12(b, d);    // x2 + y2 < 4q
    mul(t3, a, b);  // < 2.63q
    fold_2q(t3);
    sub2q(t3, t0);
    sub2q(t3, t1);  // t3 = x1 y2 + x2 y1
  }
  uint32_t z3[N], u[N], v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = twelve(i);  // t6
  copy(z3, t1);
  add2q(z3, u);             // z3 = t1 + t6
  sub2q(t1, u);             // t1 = t1 - t6
  times_3_12(u, t5, t5);    // t5 = y3 = 3b t5
  times_3_12(t0, u, t0);    // t0 = 3 t0
  mul(u, t3, t1);
  mul(v, t4, t5);
  sub2q(u, v);
  reduce_q(u);
  st(0, u);                 // X3 = t3 t1 - t4 y3
  mul(u, t1, z3);
  mul(v, t5, t0);
  add2q(u, v);
  reduce_q(u);
  st(1, u);                 // Y3 = t1 z3 + y3 3t0
  mul(u, z3, t4);
  mul(v, t0, t3);
  add2q(u, v);
  reduce_q(u);
  st(2, u);                 // Z3 = z3 t4 + 3t0 t3
}

template <bool kPairs>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
msm_gather_kernel(Args a) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= a.groups * a.lanes) return;
  const long long g = t / a.lanes;
  const long long l = t - g * a.lanes;
  const long long oo = g * N * a.lanes + l;
  const Storer st = {{a.out[0] + oo, a.out[1] + oo, a.out[2] + oo}, a.lanes};
  if (kPairs) {
    const long long i = g * a.n + 2 * l;
    const int sl = a.sid[i], sr = a.sid[i + 1];
    a.rsid[t] = sl == sr ? a.half + 1 : sl;
    const Point right = point_at(a, i + 1, sr > a.half);
    if (sl == sr && sl <= a.half) {
      g1_add_affine(PairLoader{{point_at(a, i, false), right}}, st);
    } else {
      store_point(right, st);  // a bucket boundary, or two dead lanes
    }
  } else {
    const long long j = g * a.n + (a.src ? (long long)a.src[t] : l);
    store_point(point_at(a, j, a.sid[t] > a.half), st);
  }
}

}  // namespace

// pm [rows, 36]; sid int32 [B, N] (merge) or [B, K] (gather); neg uint8 and
// perm int64 [B, N]; src int32 [B, K] or null; x, y, z [B, 12, K]; rsid int32
// [B, K] in merge mode (K = N / 2), null in gather mode.
extern "C" int zk_msm_gather(const void* pm, const void* sid, const void* neg,
                             const void* perm, const void* src, void* x,
                             void* y, void* z, void* rsid, long long groups,
                             long long lanes, long long n, int half,
                             void* stream) {
  const Args a = {(const uint32_t*)pm, (const int32_t*)sid,
                  (const uint8_t*)neg, (const long long*)perm,
                  (const int32_t*)src, {(uint32_t*)x, (uint32_t*)y,
                  (uint32_t*)z}, (int32_t*)rsid, groups, lanes, n, half};
  const unsigned grid = zk::blocks_for(groups * lanes, THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (rsid) {
    msm_gather_kernel<true><<<grid, THREADS, 0, s>>>(a);
  } else {
    msm_gather_kernel<false><<<grid, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
