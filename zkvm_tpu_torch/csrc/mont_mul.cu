// Elementwise Montgomery product over limb-major [..., L, B] batches, and a
// whole chain of them (a power by one exponent) in one launch.
//
// Replaces zkvm_tpu/ops/pallas_field.py:mont_mul_pallas (kernel
// _mont_mul_ew_kernel -> _mont_mul_k), and for `zk_mont_pow` the chain of
// those calls that `jit` makes one program of
// (zkvm_tpu/ops/limb_field.py:mont_pow).  The TPU kernel multiplies 16-bit
// limbs on the vector unit, a [L, block] tile per grid step; here each thread
// owns one lane and keeps both operands in registers as 32-bit limbs.
//
// `mont_mul_kernel` is bounded by bytes: two operands read and one result
// written against 2 N^2 + N limb products a lane.  So the design is about
// bytes and launches, not about the product (field.cuh's CIOS, which also
// takes an operand that is not below p):
//   * each operand comes with its own group, limb and lane stride in elements
//     (0 allowed), so a constant column [L, 1], one table shared by every
//     leading group and any strided view are read in place: a broadcast
//     operand costs its own bytes once (from the cache afterwards), and no
//     copy kernel runs before this one.  Limb i of lane b of a contiguous
//     operand sits at i * B + b, so a warp's loads of one limb row are
//     coalesced.  The output is contiguous.
//   * blocks of 128 threads: the SRS normalisation's [12, 65543] is 513
//     blocks, 3.9 an SM, all resident at once (one wave) and spread evenly
//     over the 132 SMs; 256 threads would leave the SMs with one or two
//     blocks each.  `zk_empty_launch` launches an empty kernel of a given
//     grid, so that a run can say how much of a short launch is the launch.
//   * `mont_pow_kernel` walks a^e for one exponent shared by all lanes, the
//     base and the accumulator in registers from the first bit to the last,
//     MSB first, one squaring a bit and one product a set bit (the branch is
//     uniform): one launch and one read and write of the tensor where the
//     chain of products took one launch and three passes over memory a
//     product.  It is bounded by operations, so here the product is the
//     carry-flag one: for Fq fq_lazy.cuh's, the accumulator in [0, 2q) and
//     reduced once at the store; for Fr fr_lazy.cuh's, the accumulator
//     canonical after every bit.  The exponent comes by value, as an
//     argument.
#include "common.cuh"
#include "field.cuh"
#include "fq_lazy.cuh"
#include "fr_lazy.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int kExpWords = 12;  // an exponent of up to 384 bits

struct Strides {
  long long group, limb, lane;
};

struct Exponent {
  uint32_t w[kExpWords];
};

template <class F>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                long long groups, long long lanes, Strides sa, Strides sb) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long l = t - g * lanes;
  const uint32_t* pa = a + g * sa.group + l * sa.lane;
  const uint32_t* pb = b + g * sb.group + l * sb.lane;
  uint32_t x[F::N], y[F::N], r[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) {
    x[i] = pa[i * sa.limb];
    y[i] = pb[i * sb.limb];
  }
  zk::mont_mul<F>(r, x, y);
  const long long base = g * F::N * lanes + l;
#pragma unroll
  for (int i = 0; i < F::N; ++i) out[base + i * lanes] = r[i];
}

// One bit of the chain, acc <- acc^2 (times base if `multiply`), and the
// value stored at the end, for each field's lazily reduced product.
template <class F>
struct Chain;

template <>
struct Chain<zk::Fq> {
  // acc in [0, 2q), base canonical: the square lands below 1.41q, its
  // product with the base below 1.15q
  __device__ __forceinline__ static void one(uint32_t* acc) {
#pragma unroll
    for (int i = 0; i < zk::Fq::N; ++i) acc[i] = zk::Fq::one(i);
  }
  __device__ __forceinline__ static void step(uint32_t* acc,
                                              const uint32_t* base,
                                              bool multiply) {
    zk::lazy::mul(acc, acc, acc);
    if (multiply) zk::lazy::mul(acc, acc, base);
  }
  __device__ __forceinline__ static void finish(uint32_t* acc) {
    zk::lazy::reduce_q(acc);
  }
};

template <>
struct Chain<zk::Fr> {
  // acc and base canonical: the square lands below 1.453r, the base times it
  // (the base is the multiplicand, the square any eight words) below 1.658r,
  // and one conditional subtraction makes either canonical again
  __device__ __forceinline__ static void one(uint32_t* acc) {
#pragma unroll
    for (int i = 0; i < zk::Fr::N; ++i) acc[i] = zk::frl::one(i);
  }
  __device__ __forceinline__ static void step(uint32_t* acc,
                                              const uint32_t* base,
                                              bool multiply) {
    zk::frl::mul(acc, acc, acc);
    if (multiply) zk::frl::mul(acc, base, acc);
    zk::frl::reduce_r(acc);
  }
  __device__ __forceinline__ static void finish(uint32_t*) {}
};

template <class F>
__global__ void __launch_bounds__(THREADS)
mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                Exponent e, int bits, long long groups, long long lanes) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= groups * lanes) return;
  const long long g = t / lanes;
  const long long base = g * F::N * lanes + (t - g * lanes);
  uint32_t x[F::N], acc[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) x[i] = a[base + i * lanes];
  Chain<F>::one(acc);
#pragma unroll 1
  for (int i = bits - 1; i >= 0; --i)
    Chain<F>::step(acc, x, (e.w[i >> 5] >> (i & 31)) & 1u);
  Chain<F>::finish(acc);
#pragma unroll
  for (int i = 0; i < F::N; ++i) out[base + i * lanes] = acc[i];
}

__global__ void empty_kernel() {}

}  // namespace

// field: 0 = Fr (8 limbs), 1 = Fq (12 limbs).  `strides`: group, limb and
// lane stride of a, then of b, in elements.  Returns cudaGetLastError().
extern "C" int zk_mont_mul(int field, const void* a, const void* b, void* out,
                           long long groups, long long lanes,
                           const long long* strides, void* stream) {
  const Strides sa = {strides[0], strides[1], strides[2]};
  const Strides sb = {strides[3], strides[4], strides[5]};
  const unsigned grid = zk::blocks_for(groups * lanes, THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (field == 0) {
    mont_mul_kernel<zk::Fr><<<grid, THREADS, 0, s>>>(pa, pb, po, groups,
                                                     lanes, sa, sb);
  } else if (field == 1) {
    mont_mul_kernel<zk::Fq><<<grid, THREADS, 0, s>>>(pa, pb, po, groups,
                                                     lanes, sa, sb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out = a^e over contiguous [groups, L, lanes] batches (Montgomery in and
// out); `exponent` holds ceil(bits / 32) little-endian words on the host.
extern "C" int zk_mont_pow(int field, const void* a, void* out,
                           const uint32_t* exponent, int bits,
                           long long groups, long long lanes, void* stream) {
  if (bits < 0 || bits > 32 * kExpWords) return (int)cudaErrorInvalidValue;
  Exponent e = {};
  for (int i = 0; i < (bits + 31) / 32; ++i) e.w[i] = exponent[i];
  const unsigned grid = zk::blocks_for(groups * lanes, THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) {
    mont_pow_kernel<zk::Fr><<<grid, THREADS, 0, s>>>(
        (const uint32_t*)a, (uint32_t*)out, e, bits, groups, lanes);
  } else if (field == 1) {
    mont_pow_kernel<zk::Fq><<<grid, THREADS, 0, s>>>(
        (const uint32_t*)a, (uint32_t*)out, e, bits, groups, lanes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A measuring probe: an empty kernel of `blocks` blocks of `threads`.
extern "C" int zk_empty_launch(long long blocks, int threads, void* stream) {
  empty_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* zk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
