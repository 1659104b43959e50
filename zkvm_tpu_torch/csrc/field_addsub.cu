// Elementwise modular addition, subtraction and negation over limb-major
// [..., L, B] batches of Fr (8 words) or Fq (12 words), with an optional lane
// mask.
//
// Replaces the field additions that `jit` fuses into every program holding
// them on the TPU (zkvm_tpu/ops/limb_field.py `add`, `sub`, `neg`), which
// have no Pallas site of their own: there a chain of them costs nothing
// beside the products it sits between, here each would be a chain of int64
// torch ops over 16-bit limbs.  One launch computes, lane by lane,
//   add: (a + b) mod p        sub: (a - b) mod p        neg: (-a) mod p
// and, with a mask, that value where the lane's mask byte is set and `a`
// where it is clear (so `select(mask, -y, y)` is one pass).
//
// The function is bounded by bytes: a few dozen instructions a lane against
// two operands read and one result written.  So the design is the one of
// mont_mul.cu's product kernel:
//   * each operand comes with its own group, limb and lane stride in
//     elements (0 allowed), the mask with its group and lane stride in
//     bytes, so an [L, 1] column, a lane broadcast, every second lane or a
//     limbs-innermost view is read in place and no copy kernel runs first;
//     the output is contiguous;
//   * one thread a lane, blocks of 128 threads, both operands in registers.
// The arithmetic is one carry chain a step with the carry in the flag
// (add.cc / addc, sub.cc / subc), every chain ONE asm statement:
//   add: s = a + b (the carry out kept), d = s - p; the result is d if the
//        sum carried out or d did not borrow, else s (the reference's
//        `_reduce_once`: exact for any s < 2p);
//   sub: d = a - b; after a borrow, d + p, the carry out of which is the
//        borrow's 2^(32 L) and is dropped;
//   neg: 0 - a the same way, so -0 = 0.
// Canonical operands give the canonical result, the limbs of the plain
// version (`kernels.field_addsub_plain`) bit for bit.
#include "common.cuh"
#include "field.cuh"

namespace {

constexpr int THREADS = 128;

struct Strides {
  long long group, limb, lane;
};

struct MaskStrides {
  long long group, lane;
};

// ---- carry chains, one asm statement each ----------------------------------

// r += b over eight words; returns the carry out (0 or 1).
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

// r += b over eight words; the carry out is dropped.
__device__ __forceinline__ void add8_drop(uint32_t* r, const uint32_t* b) {
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

// r -= b over eight words; returns 0xffffffff after a borrow, else 0.
__device__ __forceinline__ uint32_t sub8_borrow(uint32_t* r,
                                                const uint32_t* b) {
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

// r += b over twelve words; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add12_carry(uint32_t* r,
                                                const uint32_t* b) {
  uint32_t carry;
  asm("add.cc.u32 %0, %0, %13;\n\t"
      "addc.cc.u32 %1, %1, %14;\n\t"
      "addc.cc.u32 %2, %2, %15;\n\t"
      "addc.cc.u32 %3, %3, %16;\n\t"
      "addc.cc.u32 %4, %4, %17;\n\t"
      "addc.cc.u32 %5, %5, %18;\n\t"
      "addc.cc.u32 %6, %6, %19;\n\t"
      "addc.cc.u32 %7, %7, %20;\n\t"
      "addc.cc.u32 %8, %8, %21;\n\t"
      "addc.cc.u32 %9, %9, %22;\n\t"
      "addc.cc.u32 %10, %10, %23;\n\t"
      "addc.cc.u32 %11, %11, %24;\n\t"
      "addc.u32 %12, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11]), "=r"(carry)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  return carry;
}

// r += b over twelve words; the carry out is dropped.
__device__ __forceinline__ void add12_drop(uint32_t* r, const uint32_t* b) {
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
__device__ __forceinline__ uint32_t sub12_borrow(uint32_t* r,
                                                 const uint32_t* b) {
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

// The chains of one width.
template <int N>
struct Chains;

template <>
struct Chains<8> {
  __device__ __forceinline__ static uint32_t add_carry(uint32_t* r,
                                                       const uint32_t* b) {
    return add8_carry(r, b);
  }
  __device__ __forceinline__ static void add_drop(uint32_t* r,
                                                  const uint32_t* b) {
    add8_drop(r, b);
  }
  __device__ __forceinline__ static uint32_t sub_borrow(uint32_t* r,
                                                        const uint32_t* b) {
    return sub8_borrow(r, b);
  }
};

template <>
struct Chains<12> {
  __device__ __forceinline__ static uint32_t add_carry(uint32_t* r,
                                                       const uint32_t* b) {
    return add12_carry(r, b);
  }
  __device__ __forceinline__ static void add_drop(uint32_t* r,
                                                  const uint32_t* b) {
    add12_drop(r, b);
  }
  __device__ __forceinline__ static uint32_t sub_borrow(uint32_t* r,
                                                        const uint32_t* b) {
    return sub12_borrow(r, b);
  }
};

enum Op { kAdd = 0, kSub = 1, kNeg = 2 };

// r = x + y mod p (kAdd), x - y mod p (kSub) or -x mod p (kNeg; y unused).
template <class F, int OP>
__device__ __forceinline__ void field_op(uint32_t* r, const uint32_t* x,
                                         const uint32_t* y) {
  using C = Chains<F::N>;
  uint32_t k[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) k[i] = F::p(i);
  if (OP == kAdd) {
    uint32_t d[F::N];
#pragma unroll
    for (int i = 0; i < F::N; ++i) r[i] = x[i];
    const uint32_t carry = C::add_carry(r, y);
#pragma unroll
    for (int i = 0; i < F::N; ++i) d[i] = r[i];
    const uint32_t borrow = C::sub_borrow(d, k);
    const bool use_d = carry != 0 || borrow == 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) r[i] = use_d ? d[i] : r[i];
  } else {
#pragma unroll
    for (int i = 0; i < F::N; ++i) r[i] = OP == kSub ? x[i] : 0u;
    const uint32_t mask = C::sub_borrow(r, OP == kSub ? y : x);
#pragma unroll
    for (int i = 0; i < F::N; ++i) k[i] &= mask;
    C::add_drop(r, k);
  }
}

template <class F, int OP, bool MASKED>
__global__ void __launch_bounds__(THREADS)
field_addsub_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const uint8_t* __restrict__ mask,
                    uint32_t* __restrict__ out, long long groups,
                    long long lanes, Strides sa, Strides sb, MaskStrides sm) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long l = t - g * lanes;
  const uint32_t* pa = a + g * sa.group + l * sa.lane;
  uint32_t x[F::N], y[F::N], r[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) x[i] = pa[i * sa.limb];
  if (OP != kNeg) {
    const uint32_t* pb = b + g * sb.group + l * sb.lane;
#pragma unroll
    for (int i = 0; i < F::N; ++i) y[i] = pb[i * sb.limb];
  }
  field_op<F, OP>(r, x, y);
  if (MASKED && mask[g * sm.group + l * sm.lane] == 0) {
#pragma unroll
    for (int i = 0; i < F::N; ++i) r[i] = x[i];
  }
  const long long base = g * F::N * lanes + l;
#pragma unroll
  for (int i = 0; i < F::N; ++i) out[base + i * lanes] = r[i];
}

template <class F, int OP>
void launch(unsigned grid, cudaStream_t s, const uint32_t* a,
            const uint32_t* b, const uint8_t* mask, uint32_t* out,
            long long groups, long long lanes, Strides sa, Strides sb,
            MaskStrides sm) {
  if (mask != nullptr) {
    field_addsub_kernel<F, OP, true><<<grid, THREADS, 0, s>>>(
        a, b, mask, out, groups, lanes, sa, sb, sm);
  } else {
    field_addsub_kernel<F, OP, false><<<grid, THREADS, 0, s>>>(
        a, b, mask, out, groups, lanes, sa, sb, sm);
  }
}

template <class F>
int launch_op(int op, unsigned grid, cudaStream_t s, const uint32_t* a,
              const uint32_t* b, const uint8_t* mask, uint32_t* out,
              long long groups, long long lanes, Strides sa, Strides sb,
              MaskStrides sm) {
  switch (op) {
    case kAdd:
      launch<F, kAdd>(grid, s, a, b, mask, out, groups, lanes, sa, sb, sm);
      return 0;
    case kSub:
      launch<F, kSub>(grid, s, a, b, mask, out, groups, lanes, sa, sb, sm);
      return 0;
    case kNeg:
      launch<F, kNeg>(grid, s, a, b, mask, out, groups, lanes, sa, sb, sm);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// field: 0 = Fr (8 limbs), 1 = Fq (12 limbs); op: 0 = add, 1 = sub, 2 = neg
// (b unused).  `mask` is null or one byte a lane.  `strides`: group, limb
// and lane stride of a, then of b, in elements, then the group and lane
// stride of the mask in bytes.  Returns cudaGetLastError().
extern "C" int zk_field_addsub(int field, int op, const void* a,
                               const void* b, const void* mask, void* out,
                               long long groups, long long lanes,
                               const long long* strides, void* stream) {
  const Strides sa = {strides[0], strides[1], strides[2]};
  const Strides sb = {strides[3], strides[4], strides[5]};
  const MaskStrides sm = {strides[6], strides[7]};
  const unsigned grid = zk::blocks_for(groups * lanes, THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  const uint8_t* pm = (const uint8_t*)mask;
  uint32_t* po = (uint32_t*)out;
  int rc;
  if (field == 0) {
    rc = launch_op<zk::Fr>(op, grid, s, pa, pb, pm, po, groups, lanes, sa,
                           sb, sm);
  } else if (field == 1) {
    rc = launch_op<zk::Fq>(op, grid, s, pa, pb, pm, po, groups, lanes, sa,
                           sb, sm);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}
