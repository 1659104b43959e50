// The staged radix-2 NTT over Fr on limb-major [..., 8, n] batches, many
// stages a launch: natural order in, natural order out.
//
// Replaces zkvm_tpu/ops/pallas_field.py:butterfly_pallas (kernel
// _butterfly_kernel), which zkvm_tpu/ops/ntt.py:_ntt_impl_tpu runs once a
// stage under lax.scan, with a bit-reversal gather in front and gathers of
// the even, odd and twiddle operands and of the outputs around every stage.
// On the TPU a stage is one pass over the operand in its large VMEM; here
// the same walk would be log2 n launches and six passes over device memory
// a stage.  What bounds the transform on this card is the arithmetic: one
// Fr product a butterfly, but for the n - 1 a row whose twiddle is tw[0] =
// 1 (17.8 M at 2^19 x 4, 0.29 ms of 32-bit multiply-adds) against 0.04 ms
// a pass for reading and writing the operand.  So the stages run out of
// shared memory:
//
//   * The stages are cut into passes (`kernels.ntt_plan`).  Stage s pairs
//     the positions p and p + 2^s of the bit-reversed order, so the stages
//     s0 .. s0 + k - 1 of a pass pair positions that differ only in the bits
//     s0 .. s0 + k - 1: 2^k of them form a group closed under the pass.
//   * A block holds C = 2^c groups as a tile of 2^(k + c) elements (32
//     bytes each: 16 KB at 2^9) in dynamic shared memory, [limb][row][col],
//     row = the group's bits, col = the group.
//     It loads the tile, runs the k stages two at a time between barriers
//     (a thread takes four rows of a column and the three twiddles of
//     their four butterflies, two independent products side by side), and
//     writes the tile back.
//   * Later passes take as columns the position's low c bits (c <= s0), so
//     that each row of a tile is C adjacent words of every limb plane: the
//     loads and stores are runs of C words.  They work in place on `out`.
//   * The first pass folds the bit reversal into its load.  With its
//     columns the position's TOP c bits, the element (row, col) of block f
//     sits at p = col 2^(L-c) + f 2^k + row, and the input index
//        brev_L(p) = brev_k(row) 2^(L-k) + brev(f) 2^c + brev_c(col)
//     puts its C columns on C adjacent input words; its stores are runs of
//     2^k words.
//   * Tiles are small and blocks many: 2^9 elements for 2^19 (three
//     passes of 7 + 6 + 6 stages, C = 4, 8, 8), 2^10 for 2^20 (three),
//     blocks of 128 threads, four an SM (128 registers a thread, no
//     spill).  Each block waits at its own barriers and loads its own tile
//     while the others compute; measured on an H100 by tools/ntt_tiles.py,
//     that beats one block of 512 threads an SM over 2^12 tiles in two
//     passes by 12% at [4, 8, 2^19].
//   * The twiddle of the pair (p, p + 2^s) is table[(n >> (s + 1)) t],
//     t = p mod 2^s, in the [8, n/2] Montgomery table of the domain's root
//     (`Domain._twiddle_tables`), read through the read-only cache: in the
//     first pass t depends on the row alone.  Stages 0 and 1, the first
//     pass's first pair, have a step of their own: t = 0 for three of a
//     thread's four butterflies, which take no product (3n/4 of the n - 1
//     a row whose twiddle is 1; the others, one quad in 2^j of a later
//     pair, take theirs).  A step of its own and not a branch in the
//     general one: on an H100 the branch made ptxas spill, and the spill
//     cost the other passes about what the products saved.
//   * Every value between stages is canonical (fr_lazy.cuh): the twiddle
//     w < r is the multiplicand, so w y / R < 1.453 r for any canonical y,
//     one conditional subtraction makes it canonical, and the add and the
//     sub keep the sum and the difference in [0, r).  The stored words are
//     the canonical values, which are unique: the transform equals the
//     matmul route and the reference bit for bit whatever the schedule.
//   * On ANY 256-bit input it equals the plain version, that is the
//     reference's staged transform, which multiplies every odd operand by
//     its twiddle (tw[0] = 1 too: the product brings it below r) and whose
//     add keeps the carry out of 2^256 and subtracts r once: a butterfly
//     by tw[0] with no product first brings its odd operand below r
//     (`butterfly_unit`: two conditional subtractions), and every add keeps
//     the carry (`add_carry_r`, r taken off the nine-word sum), so that an
//     even operand in [r, 2^256) gives the reference's words.  On an H100
//     that form of the add ran faster than one conditional subtraction
//     after a dropped carry: the transform at [4, 8, 2^19] no slower than
//     before the repair (tools/kernel_times.py).
#include "common.cuh"
#include "fr_lazy.cuh"

namespace {

constexpr int N = zk::Fr::N;
constexpr int kMaxThreads = 128;  // a block: E / 4 threads, at most 128
constexpr int kBlocksPerSm = 4;

// the low `bits` bits of v, reversed
__device__ __forceinline__ long long brev(long long v, int bits) {
  return bits ? (long long)(__brevll((unsigned long long)v) >> (64 - bits))
              : 0;
}

// (x, y) <- (x + y, x - y) mod r for a canonical y: the reference's add
// and sub (`limb_field.add` / `sub`), which keep the carry out of 2^256 and
// subtract r once, so that any eight words x give its words; canonical
// results for a canonical x.
__device__ __forceinline__ void butterfly_one(uint32_t* x, uint32_t* y) {
  uint32_t d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = x[i];
  zk::frl::sub_r(d, y);        // x - y, or x - y + r after a borrow
  zk::frl::add_carry_r(x, y);  // x + y, less r if it is r or more
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = d[i];
}

// The butterfly whose twiddle is tw[0] = 1, with no product: y is first
// brought to its value mod r, which is what the product by R mod r gives
// (two conditional subtractions; a canonical y stays as it is).
__device__ __forceinline__ void butterfly_unit(uint32_t* x, uint32_t* y) {
  zk::frl::reduce_words(y);
  butterfly_one(x, y);
}

// (x, y) <- (x + w y, x - w y) mod r: w the canonical twiddle, y any eight
// words; canonical results for a canonical x.
__device__ __forceinline__ void butterfly(uint32_t* x, uint32_t* y,
                                          const uint32_t* w) {
  zk::frl::mul(y, w, y);  // w < r is the multiplicand: w y / R < 2 r for
  zk::frl::reduce_r(y);   // any y (1.453 r canonical); t = w y / R, canonical
  butterfly_one(x, y);
}

// One pass: the stages s0 .. s0 + k - 1 over tiles of 2^k rows and 2^c
// columns; block b takes batch row b / per_row and fixed bits f = b mod
// per_row.  The first pass (s0 == 0) reads `in` in natural order and
// writes `out`; a later one reads and writes `out` in place.
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
ntt_pass_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                const uint32_t* __restrict__ tw, int log_n, int s0, int k,
                int c, long long per_row) {
  extern __shared__ uint32_t tile[];  // [8][2^(k + c)]
  const int E = 1 << (k + c);
  const int C = 1 << c;
  const long long n = 1ll << log_n;
  const long long half = n >> 1;
  const long long g = blockIdx.x / per_row;
  const long long f = blockIdx.x - g * per_row;
  const uint32_t* src = s0 == 0 ? in + g * N * n : out + g * N * n;
  uint32_t* dst = out + g * N * n;
  // a later pass: f = hi 2^(s0 - c) + lo, p = hi 2^(s0 + k) + row 2^s0 +
  // lo 2^c + col
  const long long lo = s0 == 0 ? 0 : f & ((1ll << (s0 - c)) - 1);
  const long long hi = s0 == 0 ? 0 : f >> (s0 - c);
  const long long base = (hi << (s0 + k)) | (lo << c);

  if (s0 == 0) {
    // input row xr, column xc: element (brev_k(xr), brev_c(xc))
    const long long fb = brev(f, log_n - k - c) << c;
#pragma unroll 4
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const int xr = i >> c, xc = i & (C - 1);
      const long long xi = ((long long)xr << (log_n - k)) | fb | xc;
      const int e = (int)((brev(xr, k) << c) | brev(xc, c));
#pragma unroll
      for (int l = 0; l < N; ++l) tile[l * E + e] = src[l * n + xi];
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const long long p = base | ((long long)(i >> c) << s0) | (i & (C - 1));
#pragma unroll
      for (int l = 0; l < N; ++l) tile[l * E + i] = src[l * n + p];
    }
  }
  __syncthreads();

  // two stages between barriers: a thread takes the four rows r0 + {0, 1,
  // 2, 3} 2^j of a column (bits j and j + 1 of r0 clear), the two
  // butterflies of stage j side by side, then the two of stage j + 1; an
  // odd last stage goes alone.  The twiddle index of the pair (p, p + 2^s)
  // is t 2^(L-1-s), t = p mod 2^s: the row's low bits above s0, the
  // block's low position bits below
  const long long low = s0 == 0 ? 0 : lo << c;
  int j0 = 0;
  if (s0 == 0 && k >= 2) {
    // stages 0 and 1 (j = 0, t = 0): rows 4v + {0, 1, 2, 3} of a column;
    // the twiddle of the last butterfly is tw[n/4], of the others tw[0] = 1
    const long long wi = 1ll << (log_n - 2);
    for (int q = threadIdx.x; q < E / 4; q += blockDim.x) {
      const int col = q & (C - 1), v = q >> c;
      const int a = (v << (c + 2)) | col;
      uint32_t w[N], x[4][N];
#pragma unroll
      for (int l = 0; l < N; ++l) {
        w[l] = __ldg(tw + l * half + wi);
#pragma unroll
        for (int m = 0; m < 4; ++m) x[m][l] = tile[l * E + a + m * C];
      }
      butterfly_unit(x[0], x[1]);  // stage 0
      butterfly_unit(x[2], x[3]);
      butterfly_unit(x[0], x[2]);  // stage 1
      butterfly(x[1], x[3], w);
#pragma unroll
      for (int l = 0; l < N; ++l) {
#pragma unroll
        for (int m = 0; m < 4; ++m) tile[l * E + a + m * C] = x[m][l];
      }
    }
    __syncthreads();
    j0 = 2;
  }
  for (int j = j0; j < k; j += 2) {
    const int s = s0 + j;
    const int below = (1 << j) - 1;
    if (j + 1 < k) {
      for (int q = threadIdx.x; q < E / 4; q += blockDim.x) {
        const int col = q & (C - 1), v = q >> c;
        const int a = ((((v >> j) << (j + 2)) | (v & below)) << c) | col;
        const int step = C << j;
        const long long t =
            ((long long)(v & below) << s0) | (s0 == 0 ? 0 : low | col);
        const long long wi[3] = {t << (log_n - 1 - s), t << (log_n - 2 - s),
                                 (t | (1ll << s)) << (log_n - 2 - s)};
        uint32_t w[3][N], x[4][N];
#pragma unroll
        for (int l = 0; l < N; ++l) {
#pragma unroll
          for (int m = 0; m < 3; ++m) w[m][l] = __ldg(tw + l * half + wi[m]);
#pragma unroll
          for (int m = 0; m < 4; ++m) x[m][l] = tile[l * E + a + m * step];
        }
        butterfly(x[0], x[1], w[0]);  // stage j
        butterfly(x[2], x[3], w[0]);
        butterfly(x[0], x[2], w[1]);  // stage j + 1
        butterfly(x[1], x[3], w[2]);
#pragma unroll
        for (int l = 0; l < N; ++l) {
#pragma unroll
          for (int m = 0; m < 4; ++m) tile[l * E + a + m * step] = x[m][l];
        }
      }
    } else {
      for (int q = threadIdx.x; q < E / 2; q += blockDim.x) {
        const int col = q & (C - 1), u = q >> c;
        const int a = ((((u >> j) << (j + 1)) | (u & below)) << c) | col;
        const int b = a + (C << j);
        const long long t =
            ((long long)(u & below) << s0) | (s0 == 0 ? 0 : low | col);
        const long long wi = t << (log_n - 1 - s);
        uint32_t w[N], x[N], y[N];
#pragma unroll
        for (int l = 0; l < N; ++l) {
          w[l] = __ldg(tw + l * half + wi);
          x[l] = tile[l * E + a];
          y[l] = tile[l * E + b];
        }
        butterfly(x, y, w);
#pragma unroll
        for (int l = 0; l < N; ++l) {
          tile[l * E + a] = x[l];
          tile[l * E + b] = y[l];
        }
      }
    }
    __syncthreads();
  }

  if (s0 == 0) {
    // rows run along the output: p = col 2^(L-c) + f 2^k + row
    const int K = 1 << k;
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const int row = i & (K - 1), col = i >> k;
      const long long p = ((long long)col << (log_n - c)) | (f << k) | row;
#pragma unroll
      for (int l = 0; l < N; ++l)
        dst[l * n + p] = tile[l * E + (row << c) + col];
    }
  } else {
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const long long p = base | ((long long)(i >> c) << s0) | (i & (C - 1));
#pragma unroll
      for (int l = 0; l < N; ++l) dst[l * n + p] = tile[l * E + i];
    }
  }
}

}  // namespace

// One pass of the transform of `rows` contiguous [8, 2^log_n] rows: stages
// s0 .. s0 + k - 1 over tiles of 2^k x 2^c elements.  `in` is read by the
// first pass (s0 == 0) only; `out` must not alias it.  `tw` is the [8,
// n/2] twiddle table, whose first entry is 1 (R mod r).  Returns
// cudaGetLastError() (or the error of raising the block's shared memory
// above 48 KB: the wrapper's tiles, `kernels.NTT_LOG_TILES`, take at most
// 32 KB, so only the larger tiles that tools/ntt_tiles.py times for
// comparison go through that branch).
extern "C" int zk_ntt_pass(const void* in, void* out, const void* tw,
                           long long rows, int log_n, int s0, int k, int c,
                           void* stream) {
  const long long per_row = 1ll << (log_n - k - c);
  const int quads = (1 << (k + c)) / 4;
  const int threads = quads > kMaxThreads ? kMaxThreads : quads ? quads : 1;
  const size_t smem = (size_t)N * sizeof(uint32_t) << (k + c);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntt_pass_kernel<<<(unsigned)(rows * per_row), threads, smem,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw, log_n, s0, k,
      c, per_row);
  return (int)cudaGetLastError();
}
