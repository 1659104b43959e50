// Device arithmetic over the BLS12-381 scalar field Fr (8 x 32-bit limbs)
// and base field Fq (12 x 32-bit limbs), and the constants of the matmul
// NTT's split-fold (ntt_fold.cu).
//
// Elements are little-endian uint32 limbs in Montgomery form with
// R = 2^(32 N), held in registers.  Every function returns a fully reduced
// value in [0, p), the same canonical limbs as the reference's
// `_normalize_sub_p` (zkvm_tpu/ops/pallas_field.py), so results match the
// reference bit for bit.  Constants are compile-time immediates: with the
// limb loops unrolled, `F::p(j)` folds into the multiply-add instructions.
//
// The kernels that use these functions are bounded by 32-bit integer
// multiply throughput (IMAD/IMAD.HI, two per limb product) and by register
// pressure: one Fq product keeps ~40 words live.  This is the plain CIOS
// schedule with 64-bit products; the kernels that were designed again for
// the card use the carry-flag arithmetic of fq_lazy.cuh and fr_lazy.cuh.
#pragma once

#include <cstdint>

namespace zk {

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t NP0 = 0xffffffffu;  // -r^{-1} mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[N] = {0x00000001, 0xffffffff, 0xfffe5bfe,
                               0x53bda402, 0x09a1d805, 0x3339d808,
                               0x299d7d48, 0x73eda753};
    return v[i];
  }
  // 2^256 * R mod r and 2^512 * R mod r (R = 2^256): the Montgomery product
  // with them multiplies by 2^256 and 2^512 (the split-fold constants)
  __device__ __forceinline__ static uint32_t k1(int i) {
    constexpr uint32_t v[N] = {0xf3f29c6d, 0xc999e990, 0x87925c23,
                               0x2b6cedcb, 0x7254398f, 0x05d31496,
                               0x9f59ff11, 0x0748d9d9};
    return v[i];
  }
  __device__ __forceinline__ static uint32_t k2(int i) {
    constexpr uint32_t v[N] = {0x439b73af, 0xc62c1807, 0x8cf06990,
                               0x1b3e0d18, 0xc7b5f418, 0x73d13c71,
                               0xc8db33e9, 0x6e2a5bb9};
    return v[i];
  }
};

struct Fq {
  static constexpr int N = 12;
  static constexpr uint32_t NP0 = 0xfffcfffdu;  // -q^{-1} mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[N] = {0xffffaaab, 0xb9feffff, 0xb153ffff,
                               0x1eabfffe, 0xf6b0f624, 0x6730d2a0,
                               0xf38512bf, 0x64774b84, 0x434bacd7,
                               0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
    return v[i];
  }
  // 1 in Montgomery form (R mod q)
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[N] = {0x0002fffd, 0x76090000, 0xc40c0002,
                               0xebf4000b, 0x53c758ba, 0x5f489857,
                               0x70525745, 0x77ce5853, 0xa256ec6d,
                               0x5c071a97, 0xfa80e493, 0x15f65ec3};
    return v[i];
  }
};

// r = s - p if (top:s) >= p, else s.  Requires (top:s) < 2p.
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* s,
                                            uint32_t top) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; ++j) {
    uint64_t v = (uint64_t)s[j] - F::p(j) - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool use_d = (top != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < F::N; ++j) r[j] = use_d ? d[j] : s[j];
}

// r = a * b * R^{-1} mod p (CIOS, one word of b per outer step); r may
// alias a or b.  Every 64-bit sum below is at most (2^32-1)^2 + 2(2^32-1).
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::NP0;
    s = (uint64_t)m * F::p(0) + t[0];  // low word becomes zero
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<F>(r, t, t[N]);  // t < 2p
}

}  // namespace zk
