// Carry-flag arithmetic over the BLS12-381 scalar field Fr for the Hades
// permutation (hades.cu), the staged NTT (ntt.cu), the Fr chain of
// mont_mul.cu, the NTT's leaf reductions (ntt_fold.cu) and the quotient
// numerator (quotient.cu): the Montgomery product, the Montgomery DOT
// product that one row of the MDS matrix is, and the few reductions and
// modular additions around them.  The other kernels keep field.cuh's
// functions.
//
// What the card offers a 256-bit carry chain is its carry flag and its
// register file (see fq_lazy.cuh, whose schedule this follows): operand
// scanning in inline PTX, the partial products of the even and of the odd
// words of the multiplicand accumulated in two arrays (`ev`, `od`) that swap
// roles every row, every carry chain ONE asm statement.
//
// Fr leaves little room to be lazy.  r has 255 bits and R = 2^256 = 2.208 r
// (Fq: 9.84 q), so the ranges are stated one by one:
//
//   * `dot<K>` computes t = (sum_j a_j b_j) / R mod r for K pairs, a_j the
//     multiplicands (all eight words used in every row), b_j the operands
//     whose words are scanned.  After row i the running value is
//        V_i = (V_{i-1} + sum_j a_j b_j[i] + m_i r) / 2^32 < sum_j a_j + r,
//     because b_j[i], m_i <= 2^32 - 1; the b_j may be ANY eight words.  The
//     result is t < sum_j a_j b_j / R + r.
//   * `ev` and `od` have NINE words each.  Before the division by 2^32 the
//     running value is below 2^32 (sum_j a_j + r); `ev` holds weights
//     2^0..2^256 and `od` weights 2^32..2^288, together anything below 2^320,
//     so for K <= 5 and a_j < 2^256 no carry leaves the ninth words; every
//     term added is non-negative, so no partial sum exceeds the value.
//   * `mul` is dot<1> and keeps eight words: it needs a + r <= 2^256, that
//     is a < 1.208 r (a canonical a, in this file always).  For a < A r and
//     b < B r it lands below (A B / 2.208 + 1) r: 1.453 r for canonical
//     operands, 1.658 r for a canonical and b < 1.453 r.  NOT reduced.
//   * a square of anything at or above 1.208 r is not covered, so x^2 is
//     brought back below r (`reduce_r`) before it is squared again.
//   * `reduce_r` (one conditional subtraction of r) makes the canonical value
//     of a value below 2r.
//   * a row of the MDS matrix is dot<5> with five canonical multiplicands and
//     five canonical scanned operands: running value below 6 r = 2.72 x
//     2^256 (the ninth word is at most 2), result below (5 / 2.208 + 1) r =
//     3.27 r = 1.48 x 2^256.  `reduce_dot` subtracts 2r if the nine words are
//     not below it (3.27 r - 2 r < 2 r; what was below 2r stays), then r: two
//     conditional subtractions.
//   * the state after the MDS row and after the round constant is canonical;
//     the stored words are the canonical value, which is unique, so they
//     equal those of the fully reduced arithmetic bit for bit.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace zk {
namespace frl {

constexpr int N = Fr::N;  // 8 words

// 2r, little-endian words (below 2^256)
__device__ __forceinline__ uint32_t r2(int i) {
  constexpr uint32_t v[N] = {0x00000002, 0xfffffffe, 0xfffcb7fd, 0xa77b4805,
                             0x1343b00a, 0x6673b010, 0x533afa90, 0xe7db4ea6};
  return v[i];
}

// 1 in Montgomery form (2^256 mod r)
__device__ __forceinline__ uint32_t one(int i) {
  constexpr uint32_t v[N] = {0xfffffffe, 0x00000001, 0x00034802, 0x5884b7fa,
                             0xecbc4ff5, 0x998c4fef, 0xacc5056f, 0x1824b159};
  return v[i];
}

// ---- carry chains, one asm statement each ----------------------------------

// (acc[2k+1] : acc[2k]) += x[k] * w for k = 0..3, the carry running through
// all eight words; the carry out is added to `top` (the array's ninth word).
__device__ __forceinline__ void mad4_carry(uint32_t* acc, uint32_t& top,
                                           const uint32_t* x, uint32_t w) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(w));
}

// A row's first chain.  `od` is last row's `ev`, whose word 0 is zero and
// whose word k now has the weight of slot k - 2: ev0 += od[1], then
// (od[2k+1] : od[2k]) = x[k] * w + (od[2k+3] : od[2k+2]), the ninth word
// od[8] entering slot 6 and zero slot 7, the carry running from the first
// addition to the last word (a high half plus a carry cannot wrap).  The
// caller clears od[8] afterwards.
__device__ __forceinline__ void shift_mad4(uint32_t& ev0, uint32_t* od,
                                           const uint32_t* x, uint32_t w) {
  asm("add.cc.u32 %9, %9, %1;\n\t"
      "madc.lo.cc.u32 %0, %10, %14, %2;\n\t"
      "madc.hi.cc.u32 %1, %10, %14, %3;\n\t"
      "madc.lo.cc.u32 %2, %11, %14, %4;\n\t"
      "madc.hi.cc.u32 %3, %11, %14, %5;\n\t"
      "madc.lo.cc.u32 %4, %12, %14, %6;\n\t"
      "madc.hi.cc.u32 %5, %12, %14, %7;\n\t"
      "madc.lo.cc.u32 %6, %13, %14, %8;\n\t"
      "madc.hi.u32 %7, %13, %14, 0;"
      : "+r"(od[0]), "+r"(od[1]), "+r"(od[2]), "+r"(od[3]), "+r"(od[4]),
        "+r"(od[5]), "+r"(od[6]), "+r"(od[7]), "+r"(od[8]), "+r"(ev0)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(w));
}

// ev[k] += od[k + 1] for k = 0..7, the carry into ev[8]: the two arrays
// become one nine-word value.
__device__ __forceinline__ void merge9(uint32_t* ev, const uint32_t* od) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(ev[0]), "+r"(ev[1]), "+r"(ev[2]), "+r"(ev[3]), "+r"(ev[4]),
        "+r"(ev[5]), "+r"(ev[6]), "+r"(ev[7]), "+r"(ev[8])
      : "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]),
        "r"(od[6]), "r"(od[7]), "r"(od[8]));
}

// r += b over eight words; the caller knows the sum is below 2^256.
__device__ __forceinline__ void add8(uint32_t* r, const uint32_t* b) {
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// r += b over eight words; returns the carry out of 2^256 (0 or 1).
__device__ __forceinline__ uint32_t add8_carry(uint32_t* r,
                                               const uint32_t* b) {
  uint32_t carry;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(carry)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return carry;
}

// r -= b over eight words; returns 0xffffffff after a borrow, else 0.
__device__ __forceinline__ uint32_t sub8(uint32_t* r, const uint32_t* b) {
  uint32_t mask;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(mask)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return mask;
}

// r (nine words) -= b (eight words); returns 0xffffffff after a borrow.
__device__ __forceinline__ uint32_t sub9(uint32_t* r, const uint32_t* b) {
  uint32_t mask;
  asm("sub.cc.u32 %0, %0, %10;\n\t"
      "subc.cc.u32 %1, %1, %11;\n\t"
      "subc.cc.u32 %2, %2, %12;\n\t"
      "subc.cc.u32 %3, %3, %13;\n\t"
      "subc.cc.u32 %4, %4, %14;\n\t"
      "subc.cc.u32 %5, %5, %15;\n\t"
      "subc.cc.u32 %6, %6, %16;\n\t"
      "subc.cc.u32 %7, %7, %17;\n\t"
      "subc.cc.u32 %8, %8, 0;\n\t"
      "subc.u32 %9, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "=r"(mask)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return mask;
}

// ---- field operations --------------------------------------------------------

// x in [0, 2r) -> the canonical value in [0, r)
__device__ __forceinline__ void reduce_r(uint32_t* x) {
  uint32_t k[N], d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    k[i] = Fr::p(i);
    d[i] = x[i];
  }
  const uint32_t borrow = sub8(d, k);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = borrow ? x[i] : d[i];
}

// x = x + c mod r for canonical x and c, canonical: the sum is below 2r,
// which is below 2^256.
__device__ __forceinline__ void add_r(uint32_t* x, const uint32_t* c) {
  add8(x, c);
  reduce_r(x);
}

// Any eight words -> the canonical value: 2^256 < 2.21 r, so two
// conditional subtractions of r.  What a Montgomery product by R mod r
// (the twiddle 1) gives.
__device__ __forceinline__ void reduce_words(uint32_t* x) {
  uint32_t k[N], d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = Fr::p(i);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = x[i];
    const uint32_t borrow = sub8(d, k);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = borrow ? x[i] : d[i];
  }
}

// x = x + c, less r once where the sum is r or more, its carry out of 2^256
// kept: the reference's `limb_field.add` step for step, on ANY eight words
// x and a canonical c (the sum is below 2^256 + r, so the difference fits
// eight words).  r comes off the nine-word sum (carry : x), whose borrow
// says the sum is below r.  For canonical x it equals `add_r`.  The staged
// NTT's add (ntt.cu), where an input outside [0, r) reaches an even
// operand.
__device__ __forceinline__ void add_carry_r(uint32_t* x, const uint32_t* c) {
  uint32_t k[N], d[N + 1];
  const uint32_t carry = add8_carry(x, c);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    k[i] = Fr::p(i);
    d[i] = x[i];
  }
  d[N] = carry;
  const uint32_t borrow = sub9(d, k);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = borrow ? x[i] : d[i];
}

// x = x - c mod r for canonical x and c, canonical: r is added back after a
// borrow, and the carry out of that addition cancels the borrow.  On ANY
// eight words x and a canonical c it is the reference's `limb_field.sub`:
// x - c where x >= c, else x - c + r.
__device__ __forceinline__ void sub_r(uint32_t* x, const uint32_t* c) {
  const uint32_t borrow = sub8(x, c);
  uint32_t k[N];
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = Fr::p(i) & borrow;
  add8(x, k);
}

// t (nine words) = (sum_j a(j) b_j) / 2^256 mod r, NOT reduced:
// t < sum_j a(j) b_j / 2^256 + r, the running value below sum_j a(j) + r.
// `a(j)` gives the eight words of multiplicand j, `w(j, i)` word i of the
// operand scanned against it (any word).  K <= 5.  The operands j >= KW
// (1 <= KW <= K) are ONE word: only row 0 takes them, the other rows would
// add products by zero.
template <int K, int KW = K, class A, class W>
__device__ __forceinline__ void dot(uint32_t* t, A a, W w) {
  uint32_t re[4], ro[4], ev[N + 1], od[N + 1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    re[k] = Fr::p(2 * k);
    ro[k] = Fr::p(2 * k + 1);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // this row's arrays: they swap roles every row
    uint32_t* e = (i & 1) ? od : ev;
    uint32_t* o = (i & 1) ? ev : od;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= KW && i > 0) continue;  // a one-word operand
      const uint32_t* x = a(j);
      const uint32_t xe[4] = {x[0], x[2], x[4], x[6]};
      const uint32_t xo[4] = {x[1], x[3], x[5], x[7]};
      const uint32_t wj = w(j, i);
      if (i == 0 && j == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t pe = (uint64_t)xe[k] * wj;
          const uint64_t po = (uint64_t)xo[k] * wj;
          e[2 * k] = (uint32_t)pe;
          e[2 * k + 1] = (uint32_t)(pe >> 32);
          o[2 * k] = (uint32_t)po;
          o[2 * k + 1] = (uint32_t)(po >> 32);
        }
        e[N] = 0;
        o[N] = 0;
      } else if (j == 0) {
        shift_mad4(e[0], o, xo, wj);
        o[N] = 0;
        mad4_carry(e, e[N], xe, wj);
      } else {
        mad4_carry(o, o[N], xo, wj);
        mad4_carry(e, e[N], xe, wj);
      }
    }
    const uint32_t m = e[0] * Fr::NP0;
    mad4_carry(o, o[N], ro, m);
    mad4_carry(e, e[N], re, m);  // e[0] is now zero
  }
  // after the last (odd) row `od` played e and `ev` played o
  merge9(ev, od);
#pragma unroll
  for (int i = 0; i <= N; ++i) t[i] = ev[i];
}

// r = a b / 2^256 mod r, NOT reduced: r < (A B / 2.208 + 1) r for a < A r,
// b < B r.  Needs a < 1.208 r (the ninth word is then zero); b is any eight
// words.  r may alias a or b.
__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  uint32_t t[N + 1];
  dot<1>(t, [&](int) { return a; }, [&](int, int i) { return b[i]; });
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = t[i];
}

// t (nine words) in [0, 4r) -> r, the canonical value in [0, r): minus 2r if
// t is not below 2r, then `reduce_r`.
__device__ __forceinline__ void reduce_dot(uint32_t* r, const uint32_t* t) {
  uint32_t k[N], d[N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = r2(i);
#pragma unroll
  for (int i = 0; i <= N; ++i) d[i] = t[i];
  const uint32_t borrow = sub9(d, k);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = borrow ? t[i] : d[i];  // below 2r
  reduce_r(r);
}

// x <- x^5 for a canonical x, canonical
__device__ __forceinline__ void sbox(uint32_t* x) {
  uint32_t x2[N], x4[N];
  mul(x2, x, x);    // < 1.453 r
  reduce_r(x2);     // squared next: back below r
  mul(x4, x2, x2);  // < 1.453 r
  mul(x, x, x4);    // canonical x times any eight words: < 1.658 r
  reduce_r(x);
}

}  // namespace frl
}  // namespace zk
