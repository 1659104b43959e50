// The MSM's scalars to sort keys, and the sorted keys back to (bucket, sign,
// point index): the integer work on both sides of the bucket sort.
//
// A kernel of the port alone, with no TPU counterpart: on the TPU,
// zkvm_tpu/ops/msm.py's `_signed_digit_tensors` and the key build and unpack
// around its sort are XLA operations that no Pallas kernel holds.  Here they
// were PyTorch calls, window by window in int64 (shifts and masks of limb
// slices, a carry sweep of five launches a window, a stack and a cast), then
// about eleven launches to build the key and six to unpack it: some two
// hundred launches a pipeline call, each reading or writing whole [S*W, N]
// tensors.  This kernel reads the limbs once and writes the keys once, and
// reads the sorted keys once and writes what `msm_gather` reads.
//
//   * pack mode: thread (s, lane) reads the lane's 8 canonical 32-bit limbs
//     of limbs [S, 8, N] (limb-major: coalesced across lanes), cuts the
//     scalar into W = ceil(260 / c) windows of c bits from the bottom, and
//     sweeps the signed-digit carry through them in registers: d = u_w +
//     carry, and d - 2^c with a carry of 1 where d > half = 2^(c - 1).  Each
//     digit becomes one key of keys[s * W + w, lane]: bucket = |d|, or
//     half + 1 where d = 0 or the lane's point is at infinity (pinf[lane]);
//     neg = d < 0.  With `idx_bits` > 0 the key is (bucket << (idx_bits + 1))
//     | (neg << idx_bits) | lane, unique, so an unstable sort orders it as
//     (bucket, sign, index); with `idx_bits` = 0 it is (bucket << 1) | neg,
//     the key of a stable sort (where the packed key overflows 31 bits);
//   * unpack mode: each packed key k of sorted keys [B, N] gives sid = k >>
//     (idx_bits + 1) int32, neg = (k >> idx_bits) & 1 as a bool byte, and
//     perm = k & (2^idx_bits - 1) int64: the dtypes and layout `msm_gather`
//     takes.  Elementwise on the flattened array, four keys a thread.
// Both modes give the keys and the triple of `kernels.msm_digits_plain` (the
// PyTorch composition they replace), bit for bit.
//
// Bounded by bytes: pack mode reads 32 bytes a lane and writes 4 a digit;
// unpack mode reads 4 bytes a key and writes 13.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LIMBS = 8;

struct PackArgs {
  const uint32_t* limbs;  // [S, 8, N]
  const uint8_t* pinf;    // [N]
  int32_t* keys;          // [S * W, N]
  long long sets, n;
  int c, w_count, idx_bits;
};

__global__ void __launch_bounds__(THREADS)
msm_digits_kernel(PackArgs a) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= a.sets * a.n) return;
  const long long s = t / a.n;
  const long long lane = t - s * a.n;
  // the limbs in registers, next one first: u[0] is taken and the rest
  // move down, so that every index is a constant
  uint32_t u[LIMBS];
  const uint32_t* src = a.limbs + s * LIMBS * a.n + lane;
#pragma unroll
  for (int k = 0; k < LIMBS; ++k) u[k] = __ldg(src + k * a.n);
  const bool inf = a.pinf[lane] != 0;
  const int half = 1 << (a.c - 1);
  const int sent = half + 1;
  const uint32_t mask = (1u << a.c) - 1;
  const int low = a.idx_bits ? (int)lane : 0;
  const int neg_shift = a.idx_bits;
  const int bucket_shift = a.idx_bits + 1;
  int32_t* out = a.keys + s * a.w_count * a.n + lane;
  uint64_t buf = 0;  // the scalar's bits from window w on, `have` of them
  int have = 0;
  int carry = 0;
  for (int w = 0; w < a.w_count; ++w) {
    if (have < a.c) {  // at most one limb a window: c <= 32
      buf |= (uint64_t)u[0] << have;
      have += 32;
#pragma unroll
      for (int k = 0; k < LIMBS - 1; ++k) u[k] = u[k + 1];
      u[LIMBS - 1] = 0;  // past the 256 bits: zeros
    }
    int d = (int)(buf & mask) + carry;
    buf >>= a.c;
    have -= a.c;
    carry = d > half;
    if (carry) d -= 1 << a.c;
    const int bucket = (d == 0 || inf) ? sent : abs(d);
    out[w * a.n] = (bucket << bucket_shift) | ((d < 0) << neg_shift) | low;
  }
}

struct UnpackArgs {
  const int32_t* keys;  // [B * N], sorted along each row
  int32_t* sid;
  uint8_t* neg;
  long long* perm;
  long long count;
  int idx_bits;
};

__device__ __forceinline__ void unpack_one(const UnpackArgs& a, long long i,
                                           int32_t k) {
  a.sid[i] = k >> (a.idx_bits + 1);
  a.neg[i] = (k >> a.idx_bits) & 1;
  a.perm[i] = k & ((1 << a.idx_bits) - 1);
}

// unpack mode, four keys a thread: one 16-byte load, 16 + 4 + 32 bytes
// stored.  The same name as pack mode's, so that a trace reads either launch
// as `msm_digits_kernel`
__global__ void __launch_bounds__(THREADS)
msm_digits_kernel(UnpackArgs a) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i = 4 * q;
  if (i + 4 > a.count) {
    for (long long j = i; j < a.count; ++j) unpack_one(a, j, a.keys[j]);
    return;
  }
  const int4 k = __ldg(reinterpret_cast<const int4*>(a.keys) + q);
  const int b = a.idx_bits;
  const int32_t m = (1 << b) - 1;
  reinterpret_cast<int4*>(a.sid)[q] =
      make_int4(k.x >> (b + 1), k.y >> (b + 1), k.z >> (b + 1), k.w >> (b + 1));
  reinterpret_cast<uchar4*>(a.neg)[q] =
      make_uchar4((k.x >> b) & 1, (k.y >> b) & 1, (k.z >> b) & 1,
                  (k.w >> b) & 1);
  longlong2* p = reinterpret_cast<longlong2*>(a.perm) + 2 * q;
  p[0] = make_longlong2(k.x & m, k.y & m);
  p[1] = make_longlong2(k.z & m, k.w & m);
}

}  // namespace

// pack mode: limbs int32 [S, 8, N], pinf bool [N] -> keys int32 [S * W, N];
// idx_bits 0 for the stable-sort key
extern "C" int zk_msm_digits(const void* limbs, const void* pinf, void* keys,
                             long long sets, long long n, int c, int w_count,
                             int idx_bits, void* stream) {
  const PackArgs a = {(const uint32_t*)limbs, (const uint8_t*)pinf,
                      (int32_t*)keys, sets, n, c, w_count, idx_bits};
  msm_digits_kernel<<<zk::blocks_for(sets * n, THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// unpack mode: sorted packed keys int32 [count] -> sid int32, neg bool, perm
// int64 [count]; every pointer 16-byte aligned
extern "C" int zk_msm_digits_unpack(const void* keys, void* sid, void* neg,
                                    void* perm, long long count, int idx_bits,
                                    void* stream) {
  const UnpackArgs a = {(const int32_t*)keys, (int32_t*)sid, (uint8_t*)neg,
                        (long long*)perm, count, idx_bits};
  msm_digits_kernel<<<zk::blocks_for((count + 3) / 4, THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
