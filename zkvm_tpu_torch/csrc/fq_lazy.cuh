// Lazily reduced arithmetic over the BLS12-381 base field Fq for the two G1
// kernels of the commitment path (padd.cu, window_fold.cu), and the complete
// G1 addition built on it.  The other kernels keep field.cuh's functions.
//
// What the card offers a 384-bit carry chain is its carry flag and its
// register file, so this header differs from field.cuh in three ways:
//
//  1. The Montgomery product (`mul`) is operand scanning in inline PTX with
//     the carry in the flag (mad.lo.cc / madc.hi.cc / addc), the partial
//     products of the even and of the odd words of `a` accumulated in two
//     arrays (`ev`, `od`) that swap roles every row, so that each (lo, hi)
//     pair is one 64-bit multiply-add and the two arrays' chains do not
//     wait on each other.  Every carry chain is ONE asm statement: the flag
//     never has to survive between statements.
//  2. Nothing is reduced to [0, q) before the end.  q has 381 bits and
//     R = 2^384 = 9.84 q, and a product of a < A q and b < B q is
//     (a b + m q) / R < (A B / 9.84 + 1) q.  The invariant, with the range
//     of every value stated where it is made:
//        * a value is in [0, 2q) unless said otherwise;
//        * the sum of two values, unreduced, is in [0, 4q) and only feeds a
//          product: (4q)(4q) lands below 2.63q, one conditional subtraction
//          of 2q brings that below 2q; (2q)(2q) lands below 1.41q;
//        * `add2q` is a + b, minus 2q if that is not below 2q: [0, 2q);
//        * `sub2q` is a - b, plus 2q after a borrow: [0, 2q);
//        * `reduce_q` (one conditional subtraction of q) makes the
//          canonical value of a value below 2q, at the store.
//     The canonical value of a residue is unique, so the stored limbs equal
//     those of the fully reduced arithmetic bit for bit.
//  3. The two products by the constant 3b = 12 of RCB15 algorithm 7 are four
//     additions: 12 t = 2 (2 (t + t + t)), and 3 t falls out on the way.
//
// `mul` needs a + q < 2^384 (any a < 8q; here a < 4q) and takes any
// 12-word b.  Why no carry is lost: after row i the running value is
// V_i = (V_{i-1} + a b_i + m_i q) / 2^32 < a + q, so before the division it
// is below 2^32 (a + q) < 2^416; `ev` holds words of weight 2^0..2^352 and
// `od` words of weight 2^32..2^384, every term added is non-negative, so
// each partial sum is at most that value: the carry out of `od`'s top word
// (weight 2^416) is always zero, and the carry out of `ev`'s top word has
// the weight of `od`'s top word, where it is added.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace zk {
namespace lazy {

constexpr int N = Fq::N;  // 12 words

// 2q, little-endian words
__device__ __forceinline__ uint32_t q2(int i) {
  constexpr uint32_t v[N] = {0xffff5556, 0x73fdffff, 0x62a7ffff, 0x3d57fffd,
                             0xed61ec48, 0xce61a541, 0xe70a257e, 0xc8ee9709,
                             0x869759ae, 0x96374f6c, 0x72ffcd34, 0x340223d4};
  return v[i];
}

// ---- carry chains, one asm statement each ----------------------------------

// (acc[2k+1] : acc[2k]) += x[k] * w for k = 0..5, the carry running through
// all twelve words; the carry out is added to `top`.
__device__ __forceinline__ void mad6_carry(uint32_t* acc, uint32_t& top,
                                           const uint32_t* x, uint32_t w) {
  asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
        "+r"(acc[10]), "+r"(acc[11]), "+r"(top)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(w));
}

// The same without a carry out: the caller knows it is zero.
__device__ __forceinline__ void mad6_drop(uint32_t* acc, const uint32_t* x,
                                          uint32_t w) {
  asm("mad.lo.cc.u32 %0, %12, %18, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %18, %7;\n\t"
      "madc.lo.cc.u32 %8, %16, %18, %8;\n\t"
      "madc.hi.cc.u32 %9, %16, %18, %9;\n\t"
      "madc.lo.cc.u32 %10, %17, %18, %10;\n\t"
      "madc.hi.u32 %11, %17, %18, %11;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
        "+r"(acc[10]), "+r"(acc[11])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(w));
}

// The row's first chain.  `od` is last row's `ev`, whose word 0 is zero and
// whose word k now has the weight of slot k - 2: ev0 += od[1], then
// (od[2k+1] : od[2k]) = x[k] * w + (od[2k+3] : od[2k+2]), zeros shifted in
// at the top, the carry running from the first addition to the last word.
__device__ __forceinline__ void shift_mad6(uint32_t& ev0, uint32_t* od,
                                           const uint32_t* x, uint32_t w) {
  asm("add.cc.u32 %12, %12, %1;\n\t"
      "madc.lo.cc.u32 %0, %13, %19, %2;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %3;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %4;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %5;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %6;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %7;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %8;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %9;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %10;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %11;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, 0;\n\t"
      "madc.hi.u32 %11, %18, %19, 0;"
      : "+r"(od[0]), "+r"(od[1]), "+r"(od[2]), "+r"(od[3]), "+r"(od[4]),
        "+r"(od[5]), "+r"(od[6]), "+r"(od[7]), "+r"(od[8]), "+r"(od[9]),
        "+r"(od[10]), "+r"(od[11]), "+r"(ev0)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(w));
}

// ev[k] += od[k + 1] for k = 0..10, the carry into ev[11]: the two arrays
// become one 12-word value.
__device__ __forceinline__ void merge(uint32_t* ev, const uint32_t* od) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, 0;"
      : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
        "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7]), "+r"(ev[8]), "+r"(ev[9]),
        "+r"(ev[10]), "+r"(ev[11])
      : "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]),
        "r"(od[6]), "r"(od[7]), "r"(od[8]), "r"(od[9]), "r"(od[10]),
        "r"(od[11]));
}

// r += b over twelve words; the caller knows the sum is below 2^384.
__device__ __forceinline__ void add12(uint32_t* r, const uint32_t* b) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
}

// r -= b over twelve words; returns 0xffffffff after a borrow, else 0.
__device__ __forceinline__ uint32_t sub12(uint32_t* r, const uint32_t* b) {
  uint32_t mask;
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11]), "=r"(mask)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  return mask;
}

// ---- field operations --------------------------------------------------------

__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = a[i];
}

// r = r - K if r >= K, else r, for the constant K = 2q (`two`) or q.
template <bool two>
__device__ __forceinline__ void cond_sub(uint32_t* r) {
  uint32_t k[N], d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    k[i] = two ? q2(i) : Fq::p(i);
    d[i] = r[i];
  }
  const uint32_t borrow = sub12(d, k);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = borrow ? r[i] : d[i];
}

// r in [0, 4q) -> [0, 2q), the same residue
__device__ __forceinline__ void fold_2q(uint32_t* r) { cond_sub<true>(r); }

// r in [0, 2q) -> the canonical value in [0, q)
__device__ __forceinline__ void reduce_q(uint32_t* r) { cond_sub<false>(r); }

// r = r + b; r, b in [0, 2q) -> [0, 2q)
__device__ __forceinline__ void add2q(uint32_t* r, const uint32_t* b) {
  add12(r, b);  // below 4q
  fold_2q(r);
}

// r = r - b; r, b in [0, 2q) -> [0, 2q)
__device__ __forceinline__ void sub2q(uint32_t* r, const uint32_t* b) {
  const uint32_t borrow = sub12(r, b);
  uint32_t k[N];
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = q2(i) & borrow;
  add12(r, k);  // the carry out cancels the borrow
}

// t in [0, 2q) -> t3 = 3 t and t12 = 12 t, both in [0, 2q): four additions.
// t3 or t12 may alias t.
__device__ __forceinline__ void times_3_12(uint32_t* t3, uint32_t* t12,
                                           const uint32_t* t) {
  uint32_t s[N], u[N];
  copy(s, t);
  add2q(s, t);   // 2 t
  add2q(s, t);   // 3 t
  copy(u, s);
  add2q(u, s);   // 6 t
  copy(t3, s);
  copy(s, u);
  add2q(u, s);   // 12 t
  copy(t12, u);
}

// r = a b / 2^384 mod q, NOT reduced: r < (A B / 9.84 + 1) q for a < A q,
// b < B q.  Needs a < 8q.  r may alias a or b.
__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  uint32_t ae[6], ao[6], qe[6], qo[6], ev[N], od[N];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    ae[k] = a[2 * k];
    ao[k] = a[2 * k + 1];
    qe[k] = Fq::p(2 * k);
    qo[k] = Fq::p(2 * k + 1);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // this row's arrays: they swap roles every row
    uint32_t* e = (i & 1) ? od : ev;
    uint32_t* o = (i & 1) ? ev : od;
    const uint32_t w = b[i];
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const uint64_t pe = (uint64_t)ae[k] * w;
        const uint64_t po = (uint64_t)ao[k] * w;
        e[2 * k] = (uint32_t)pe;
        e[2 * k + 1] = (uint32_t)(pe >> 32);
        o[2 * k] = (uint32_t)po;
        o[2 * k + 1] = (uint32_t)(po >> 32);
      }
    } else {
      shift_mad6(e[0], o, ao, w);
      mad6_carry(e, o[N - 1], ae, w);
    }
    const uint32_t m = e[0] * Fq::NP0;
    mad6_drop(o, qo, m);
    mad6_carry(e, o[N - 1], qe, m);  // e[0] is now zero
  }
  // after the last (odd) row `od` played e and `ev` played o
  merge(ev, od);
  copy(r, ev);
}

// ---- complete G1 addition, one thread ------------------------------------------

// (x3, y3, z3) = P + Q by RCB15 algorithm 7 (a = 0), canonical outputs.
// `ld(dst, k)` fetches coordinate k (0..2: x1 y1 z1, 3..5: x2 y2 z2), each a
// value in [0, 2q), when it is needed: x1 and x2 are fetched twice, so that
// at most four coordinates are live beside the six products.  `st(k, src)`
// stores output coordinate k as soon as it is done.
template <class Load, class Store>
__device__ __forceinline__ void g1_add(Load ld, Store st) {
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N], t5[N];
  {
    uint32_t a[N], b[N], c[N], d[N];
    ld(a, 0);
    ld(b, 3);
    mul(t0, a, b);  // x1 x2 < 1.41q
    ld(c, 1);
    ld(d, 4);
    mul(t1, c, d);  // y1 y2 < 1.41q
    add12(a, c);    // x1 + y1 < 4q
    add12(b, d);    // x2 + y2 < 4q
    mul(t3, a, b);  // < 2.63q
    fold_2q(t3);
    sub2q(t3, t0);
    sub2q(t3, t1);  // t3 = x1 y2 + x2 y1
    ld(a, 2);
    ld(b, 5);
    mul(t2, a, b);  // z1 z2 < 1.41q
    add12(c, a);    // y1 + z1 < 4q
    add12(d, b);    // y2 + z2 < 4q
    mul(t4, c, d);  // < 2.63q
    fold_2q(t4);
    sub2q(t4, t1);
    sub2q(t4, t2);  // t4 = y1 z2 + y2 z1
    ld(c, 0);
    ld(d, 3);
    add12(a, c);    // z1 + x1 < 4q
    add12(b, d);    // z2 + x2 < 4q
    mul(t5, a, b);  // < 2.63q
    fold_2q(t5);
    sub2q(t5, t0);
    sub2q(t5, t2);  // t5 = x1 z2 + x2 z1
  }
  uint32_t z3[N], u[N], v[N];
  times_3_12(u, t2, t2);    // t2 = t6 = 3b t2
  copy(z3, t1);
  add2q(z3, t2);            // z3 = t1 + t6
  sub2q(t1, t2);            // t1 = t1 - t6
  times_3_12(u, t5, t5);    // t5 = y3 = 3b t5
  times_3_12(t0, u, t0);    // t0 = 3 t0
  // every operand below is in [0, 2q): products < 1.41q
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

// ---- complete G1 addition, six threads of an 8-lane group ------------------------

// r[i] = k == 0 ? a0[i] : k == 1 ? a1[i] : a2[i]
__device__ __forceinline__ void pick3(uint32_t* r, int k, const uint32_t* a0,
                                      const uint32_t* a1,
                                      const uint32_t* a2) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = k == 0 ? a0[i] : (k == 1 ? a1[i] : a2[i]);
}

// r = lane `src` (of this 8-lane group) 's s
__device__ __forceinline__ void from_lane(uint32_t* r, const uint32_t* s,
                                          int src) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = __shfl_sync(0xffffffffu, s[i], src, 8);
}

// entry `role` of a table of eight 4-bit entries
__device__ __forceinline__ int nibble(uint32_t table, int role) {
  return (int)((table >> (4 * role)) & 7u);
}

// (px, py, pz) += (qx, qy, qz), every lane of an 8-lane group holding the same
// points, coordinates in [0, 2q) before and after.  Q may be P (a doubling).
// The 6 + 6 independent products of the addition run side by side on the
// lanes role = 0..5 of the group (roles 6 and 7 repeat 0 and 1 and are read
// by nobody), so the addition is two products deep.  All lanes run the same
// instructions; the role only selects operands and shuffle sources:
//
//   stage 1   role 0: t0 = x1 x2   1: t1 = y1 y2   2: t2 = z1 z2
//             3: (x1+y1)(x2+y2)    4: (y1+z1)(y2+z2)   5: (x1+z1)(x2+z2)
//     roles 3, 4, 5 subtract (t0, t1), (t1, t2), (t0, t2): t3, t4, t5
//     all compute 3 m and 12 m of their value m; kept: role 0: 3 t0,
//     role 2: t6 = 12 t2, role 5: y3 = 12 t5
//     role 1 reads t6: keeps z3 = t1 + t6 (in `p`) and t1 - t6 (in `s`)
//   stage 2   role 0: t3 t1   1: t4 y3   2: z3 t1   3: y3 3t0   4: z3 t4
//             5: 3t0 t3
//     pairs (0,1), (2,3), (4,5) exchange: role 0 has X3 = u0 - u1, role 2
//     Y3 = u2 + u3, role 4 Z3 = u4 + u5; all lanes read the three.
__device__ __forceinline__ void g1_add_coop(uint32_t* px, uint32_t* py,
                                            uint32_t* pz, const uint32_t* qx,
                                            const uint32_t* qy,
                                            const uint32_t* qz, int role) {
  const int first = nibble(0x10010210u, role);   // x y z x y x | x y
  const int second = nibble(0x00221000u, role);  // - - - y z z | - -
  const bool sum = role >= 3 && role <= 5;
  uint32_t m[N], p[N], s[N];
  {
    uint32_t a[N], b[N];
    pick3(a, first, px, py, pz);
    pick3(b, first, qx, qy, qz);
    pick3(p, second, px, py, pz);
    pick3(s, second, qx, qy, qz);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p[i] = sum ? p[i] : 0u;
      s[i] = sum ? s[i] : 0u;
    }
    add12(a, p);   // < 4q
    add12(b, s);   // < 4q
    mul(m, a, b);  // < 2.63q
    fold_2q(m);
  }
  // roles 3, 4, 5 subtract their two products; the others subtract zero
  from_lane(p, m, nibble(0x00010000u, role));  // - - - t0 t1 t0
  from_lane(s, m, nibble(0x00221000u, role));  // - - - t1 t2 t2
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = sum ? p[i] : 0u;
    s[i] = sum ? s[i] : 0u;
  }
  sub2q(m, p);
  sub2q(m, s);
  {
    uint32_t m3[N], m12[N];
    times_3_12(m3, m12, m);
    const bool keep12 = role == 2 || role == 5;
    const bool keep3 = role == 0 || role == 6;
#pragma unroll
    for (int i = 0; i < N; ++i)
      p[i] = keep12 ? m12[i] : (keep3 ? m3[i] : m[i]);
  }
  {
    uint32_t t6[N], z3[N];
    from_lane(t6, p, 2);
    copy(z3, p);
    add2q(z3, t6);
    copy(s, p);
    sub2q(s, t6);  // role 1: t1 - t6
    const bool is1 = role == 1 || role == 7;
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = is1 ? z3[i] : p[i];
  }
  // p: 3t0 | z3 | t6 | t3 | t4 | y3;  s of role 1: t1 - t6
  {
    uint32_t a[N], b[N], c[N];
    from_lane(a, p, nibble(0x43015143u, role));  // t3 t4 z3 y3 z3 3t0 | t3 t4
    from_lane(b, p, nibble(0x51340151u, role));  // -  y3 -  3t0 t4 t3 | -  y3
    from_lane(c, s, 1);                          // t1 - t6
    const bool with_t1 = role == 0 || role == 2 || role == 6;
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = with_t1 ? c[i] : b[i];
    mul(m, a, b);  // < 1.41q
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __shfl_xor_sync(0xffffffffu, m[i], 1, 8);
  copy(p, m);
  sub2q(p, s);   // role 0: X3
  add2q(m, s);   // role 2: Y3, role 4: Z3
  const bool diff = role == 0;
#pragma unroll
  for (int i = 0; i < N; ++i) m[i] = diff ? p[i] : m[i];
  from_lane(px, m, 0);
  from_lane(py, m, 2);
  from_lane(pz, m, 4);
}

}  // namespace lazy
}  // namespace zk
