// The PLONK quotient over the 8n coset, lane by lane: the numerator of the
// gate and permutation identities times Z_H^-1, in one launch.
//
// Replaces zkvm_tpu/ops/quotient_kernel.py's two jitted programs,
// `quotient_numerator` (:73-74) and `pointwise_divide` (:188-189): there is
// no Pallas site, but XLA fuses each chain of limb arithmetic into one TPU
// program, where the port's chain (`ops/quotient_kernel.py`) is some 240
// launches of `mont_mul` and `field_addsub`, each reading and writing full
// [8, 8n] tensors.
//
// Why its words equal the chain's whatever the schedule.  The contract is
// canonical operands (every word below r), which the path meets: the coset
// FFT's outputs, their rolls and the key's cached tables.  For canonical
// inputs the chain's output is the canonical value of one field expression,
// and canonical values are unique.  So the kernel may reorder, regroup and
// rewrite the expression -- 4a as two doublings, f(f-1)(f-2)(f-3) as u(u+2)
// with u = f^2 - 3f, a sum of products as one Montgomery dot product, a
// separator folded into its widget's powers, the widgets summed in two
// halves -- as long as every value it keeps is canonical: each product is
// reduced below r (fr_lazy.cuh's `mul` lands below 1.453 r, `reduce_dot`
// takes a dot product of up to five pairs to [0, r)), and each sum and
// difference stays in [0, r) (`add_r`, `sub_r`).  Every output word then
// equals the chain's.
//
// Design for the card.  The work is carry-flag arithmetic: a lane takes 49
// products and 11 dot products (`kernels.quotient_multiply_adds`: 19,776
// 32-bit multiply-adds, where the chain takes 113 products of full width,
// 30,736), so it is bound by operations.  One thread a lane wanted ~255
// registers: at four blocks of 128 threads an SM it spilled 1,064 bytes a
// thread and ran at 41% of its bound on an H100.
//   * two threads a lane: the first computes the arithmetic, fixed-base and
//     logic widgets (9,648 multiply-adds), the second the variable-base,
//     range and permutation widgets (9,856), each summing its widgets into
//     its own canonical `total`.  After the block's barrier the second adds
//     the first's sum and the public inputs, multiplies by Z_H^-1 (272) and
//     stores the lane.  The two threads of a pair are warps w and w + 1 of a
//     block (kPairBit = 5): a warp runs one half, so no warp diverges, and
//     every load of a limb row is 32 neighbouring lanes, 128 bytes;
//   * the product is one function in the code (`stmt::product`, not
//     inlined), called by the 49 statements that take one.  Inlined, the
//     kernel's code is twice as long, more than the SM's instruction cache
//     holds, and the warps, spread over two programs, wait on instruction
//     fetches whatever the warps an SM: 1.07 against 0.87 ms at [8, 2^19]
//     on an H100 (`tools/quotient_bounds.py` builds both).  A call also
//     keeps ptxas from interleaving the statements around it, so a thread
//     holds about the values the program holds;
//   * few live values: each widget reads the wires it needs itself, and
//     forms again what is cheap to form (a_sd, 1 - c a b D) rather than
//     hold it; the sums and the values held across dot products are parked
//     in shared memory (`park`);
//   * the operands a lane reads more than once (the wires, q_c, q_l, q_r)
//     are copied to shared memory once, by the two threads of the pair,
//     before the halves start (`stage`): each operand is read from the
//     device once, and no read waits on L2 for a row that left L1;
//   * the challenges' powers and the constants live in constant memory
//     (`c_table`, copied from the wrapper's [31, 8] table on the stream
//     before the launch): every thread reads the same word, which the
//     multiply-adds take straight from the constant bank, in no register.
//     The copy is stream-ordered, so calls on one stream (the port's) see
//     their own table; the products by 2, 3, 4, 9, 18 s and the
//     permutation's K1, K2, K3 (7, 13, 17) are additions;
//   * sums of products are Montgomery dot products of two to five pairs:
//     one reduction instead of one a product.  They stay inlined: called,
//     their operands would pass through the stack.
// At four blocks of 128 threads an SM a thread takes 120 registers and
// spills nothing (`tools/quotient_bounds.py` sweeps the launch bounds and
// the pairing).
//
// The programs of the two halves and of the combine (between the markers in
// `quotient_kernel`) and the two functions they call are written in nine
// statements only -- ld, tb, st, meet, fmul, fadd, fsub, fneg, fdot2 ..
// fdot5 -- so that the CPU model (`tests/test_torch_quotient_design.py`)
// reads them from here and executes them on the carry chains of
// fr_lazy.cuh.
#include "common.cuh"
#include "fr_lazy.cuh"

namespace {

constexpr int N = zk::Fr::N;
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 4;
// the two threads of a pair differ in this bit of the thread index: 5 pairs
// warp w with warp w + 1, 4 thread t with t + 16, 0 neighbouring threads
constexpr int kPairBit = 5;
constexpr int kPairs = kThreads / 2;  // lanes a block
// values kept in shared memory, a slot a pair each: the two halves' sums,
// three values the first half holds across dot products, one the second
// holds
constexpr int kParked = 6;

// the operands, in the wrapper's order (`kernels.QUOTIENT_OPERANDS`)
enum Operand {
  k_q_m, k_q_l, k_q_r, k_q_o, k_q_f, k_q_c, k_q_arith, k_q_range, k_q_logic,
  k_q_fixed_group_add, k_q_variable_group_add, k_s_sigma_1, k_s_sigma_2,
  k_s_sigma_3, k_s_sigma_4, k_a, k_b, k_c, k_d, k_a_w, k_b_w, k_d_w, k_z,
  k_z_w, k_pi, k_l1_alpha_sq, k_linear, k_v_h_inv, kOperands
};

// the entries of the challenge table (`kernels.QUOTIENT_TABLE`): the seven
// challenges, each separator s times kappa^i (kappa = s^2), -alpha and the
// constants
enum Entry {
  t_alpha, t_beta, t_gamma, t_range_sep, t_logic_sep, t_fixed_sep,
  t_var_sep, t_range_0, t_range_1, t_range_2, t_range_3, t_logic_0,
  t_logic_1, t_logic_2, t_logic_3, t_logic_4, t_fixed_0, t_fixed_1,
  t_fixed_2, t_fixed_3, t_var_0, t_var_1, t_var_2, t_neg_alpha, t_one,
  t_two, t_eighteen, t_eighty_one, t_neg_eighty_one, t_eighty_three,
  t_jubjub_d, kEntries
};

struct Operands {
  const uint32_t* p[kOperands];
  long long limb_stride[kOperands];  // elements; lanes are contiguous
};

// a value a thread keeps in shared memory, out of its registers: its slot
// of `park` in quotient_kernel
struct Park {
  uint32_t* p;
};

// the words of a value in registers or parked
__device__ __forceinline__ uint32_t* words(uint32_t* x) { return x; }
__device__ __forceinline__ uint32_t* words(Park x) { return x.p; }

// the operands a lane reads more than once (the seven wires, q_c, q_l,
// q_r): the block copies them to shared memory first, and `ld` reads them
// there.  Operand staged(j) is row j of `stage`; stage_of(k) is the row of
// operand k, or -1.
constexpr int kStages = 10;

__device__ constexpr int staged(int j) {
  switch (j) {
    case 0: return k_a;
    case 1: return k_b;
    case 2: return k_c;
    case 3: return k_d;
    case 4: return k_a_w;
    case 5: return k_b_w;
    case 6: return k_d_w;
    case 7: return k_q_c;
    case 8: return k_q_l;
    default: return k_q_r;
  }
}

__device__ constexpr int stage_of(int k) {
  for (int j = 0; j < kStages; ++j)
    if (staged(j) == k) return j;
  return -1;
}

// the challenge table of the launch that follows its copy
__constant__ uint32_t c_table[kEntries * N];

namespace stmt {

// ---- the statements (canonical operands and results) ----------------------

// an element of Fr by value: eight words, passed in registers
struct Word8 {
  uint32_t w[N];
};

// a b / R mod r, canonical.  Not inlined: the kernel's code holds the
// product once, and a lane's 49 products are calls of it (the design note
// at the top).
__device__ __noinline__ Word8 product(Word8 a, Word8 b) {
  Word8 r;
  zk::frl::mul(r.w, a.w, b.w);  // a canonical: below 1.453 r
  zk::frl::reduce_r(r.w);
  return r;
}

// r = a b / R mod r.  r may alias a or b.
__device__ __forceinline__ void fmul(uint32_t* r, const uint32_t* a,
                                     const uint32_t* b) {
  Word8 x, y;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x.w[i] = a[i];
    y.w[i] = b[i];
  }
  const Word8 t = product(x, y);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = t.w[i];
}

// r = a + b mod r.  r may alias a or b.
__device__ __forceinline__ void fadd(uint32_t* r, const uint32_t* a,
                                     const uint32_t* b) {
  uint32_t t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = a[i];
  zk::frl::add_r(t, b);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = t[i];
}

// r = a - b mod r.  r may alias a or b.
__device__ __forceinline__ void fsub(uint32_t* r, const uint32_t* a,
                                     const uint32_t* b) {
  uint32_t t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = a[i];
  zk::frl::sub_r(t, b);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = t[i];
}

// r = -a mod r.  r may alias a.
__device__ __forceinline__ void fneg(uint32_t* r, const uint32_t* a) {
  uint32_t t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = 0;
  zk::frl::sub_r(t, a);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = t[i];
}

// r = (sum_j x[j] y[j]) / R mod r: the x[j] are the multiplicands, the y[j]
// the scanned operands.  Below (K / 2.208 + 1) r <= 3.27 r before
// `reduce_dot`.  r may alias any operand.
template <int K>
__device__ __forceinline__ void fdot(uint32_t* r, const uint32_t* const* x,
                                     const uint32_t* const* y) {
  uint32_t t[N + 1];
  zk::frl::dot<K>(
      t, [&](int j) { return x[j]; }, [&](int j, int i) { return y[j][i]; });
  zk::frl::reduce_dot(r, t);
}

__device__ __forceinline__ void fdot2(uint32_t* r, const uint32_t* x0,
                                      const uint32_t* y0, const uint32_t* x1,
                                      const uint32_t* y1) {
  const uint32_t* x[2] = {x0, x1};
  const uint32_t* y[2] = {y0, y1};
  fdot<2>(r, x, y);
}

__device__ __forceinline__ void fdot3(uint32_t* r, const uint32_t* x0,
                                      const uint32_t* y0, const uint32_t* x1,
                                      const uint32_t* y1, const uint32_t* x2,
                                      const uint32_t* y2) {
  const uint32_t* x[3] = {x0, x1, x2};
  const uint32_t* y[3] = {y0, y1, y2};
  fdot<3>(r, x, y);
}

__device__ __forceinline__ void fdot4(uint32_t* r, const uint32_t* x0,
                                      const uint32_t* y0, const uint32_t* x1,
                                      const uint32_t* y1, const uint32_t* x2,
                                      const uint32_t* y2, const uint32_t* x3,
                                      const uint32_t* y3) {
  const uint32_t* x[4] = {x0, x1, x2, x3};
  const uint32_t* y[4] = {y0, y1, y2, y3};
  fdot<4>(r, x, y);
}

__device__ __forceinline__ void fdot5(uint32_t* r, const uint32_t* x0,
                                      const uint32_t* y0, const uint32_t* x1,
                                      const uint32_t* y1, const uint32_t* x2,
                                      const uint32_t* y2, const uint32_t* x3,
                                      const uint32_t* y3, const uint32_t* x4,
                                      const uint32_t* y4) {
  const uint32_t* x[5] = {x0, x1, x2, x3, x4};
  const uint32_t* y[5] = {y0, y1, y2, y3, y4};
  fdot<5>(r, x, y);
}

// ---- two functions of the program, in its statements -----------------------

// r = hi - 4 lo
__device__ __forceinline__ void minus4(uint32_t* r, const uint32_t* hi,
                                       const uint32_t* lo) {
  uint32_t t[N];
  fadd(t, lo, lo);
  fadd(t, t, t);
  fsub(r, hi, t);
}

// r = f (f - 1) (f - 2) (f - 3) = u (u + 2), u = f^2 - 3 f (the range and
// logic widgets' delta); `two` is 2 in Montgomery form
__device__ __forceinline__ void delta(uint32_t* r, const uint32_t* f,
                                      const uint32_t* two) {
  uint32_t u[N], t[N];
  fmul(u, f, f);
  fadd(t, f, f);
  fadd(t, t, f);
  fsub(u, u, t);
  fadd(t, u, two);
  fmul(r, u, t);
}

}  // namespace stmt

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
quotient_kernel(const Operands in, uint32_t* __restrict__ out,
                long long lanes) {
  // the values the threads keep out of their registers (slot 0 the first
  // half's sum, which the second reads after the barrier), and the operands
  // a lane reads more than once
  __shared__ uint32_t park[kParked][kPairs][N + 1];
  __shared__ uint32_t stage[kStages][N][kPairs];
  const int half = (threadIdx.x >> kPairBit) & 1;
  const int slot = ((threadIdx.x >> (kPairBit + 1)) << kPairBit) |
                   (threadIdx.x & ((1 << kPairBit) - 1));
  const long long pair = (long long)blockIdx.x * kPairs + slot;
  // past the last lane a pair computes the last lane again and stores
  // nothing: both threads reach the barriers
  const long long lane = pair < lanes ? pair : lanes - 1;
  // the two threads of a pair copy half of the staged operands each
#pragma unroll
  for (int j = half; j < kStages; j += 2) {
    const int k = staged(j);
#pragma unroll
    for (int l = 0; l < N; ++l)
      stage[j][l][slot] = __ldg(in.p[k] + l * in.limb_stride[k] + lane);
  }
  __syncthreads();
  // operand k of this lane; entry k of the table; the output; the other
  // half's sum
  auto ld = [&](uint32_t* x, int k) {
    const int j = stage_of(k);
#pragma unroll
    for (int l = 0; l < N; ++l)
      x[l] = j >= 0 ? stage[j][l][slot]
                    : __ldg(in.p[k] + l * in.limb_stride[k] + lane);
  };
  auto tb = [&](uint32_t* x, int k) {
#pragma unroll
    for (int l = 0; l < N; ++l) x[l] = c_table[k * N + l];
  };
  auto st = [&](Park x) {
    if (pair < lanes) {
#pragma unroll
      for (int l = 0; l < N; ++l) out[l * lanes + pair] = x.p[l];
    }
  };
  auto meet = [&](uint32_t* x) {
#pragma unroll
    for (int l = 0; l < N; ++l) x[l] = park[0][slot][l];
  };

  // The statements of the program, on operands in registers or parked:
  // each copies its operands into registers (`get`), calls stmt's function
  // of its name, and copies the result out (`put`).
  auto get = [&](uint32_t* s, auto x) {
    const uint32_t* from = words(x);
#pragma unroll
    for (int l = 0; l < N; ++l) s[l] = from[l];
  };
  auto put = [&](auto r, const uint32_t* s) {
    uint32_t* to = words(r);
#pragma unroll
    for (int l = 0; l < N; ++l) to[l] = s[l];
  };
  auto fmul = [&](auto r, auto a, auto b) {
    uint32_t x[N], y[N], t[N];
    get(x, a);
    get(y, b);
    stmt::fmul(t, x, y);
    put(r, t);
  };
  auto fadd = [&](auto r, auto a, auto b) {
    uint32_t x[N], y[N], t[N];
    get(x, a);
    get(y, b);
    stmt::fadd(t, x, y);
    put(r, t);
  };
  auto fsub = [&](auto r, auto a, auto b) {
    uint32_t x[N], y[N], t[N];
    get(x, a);
    get(y, b);
    stmt::fsub(t, x, y);
    put(r, t);
  };
  auto fneg = [&](auto r, auto a) {
    uint32_t x[N], t[N];
    get(x, a);
    stmt::fneg(t, x);
    put(r, t);
  };
  auto minus4 = [&](auto r, auto hi, auto lo) {
    uint32_t x[N], y[N], t[N];
    get(x, hi);
    get(y, lo);
    stmt::minus4(t, x, y);
    put(r, t);
  };
  auto delta = [&](auto r, auto f, auto two) {
    uint32_t x[N], y[N], t[N];
    get(x, f);
    get(y, two);
    stmt::delta(t, x, y);
    put(r, t);
  };
  auto fdot2 = [&](auto r, auto x0, auto y0, auto x1, auto y1) {
    uint32_t a0[N], b0[N], a1[N], b1[N], t[N];
    get(a0, x0);
    get(b0, y0);
    get(a1, x1);
    get(b1, y1);
    stmt::fdot2(t, a0, b0, a1, b1);
    put(r, t);
  };
  auto fdot3 = [&](auto r, auto x0, auto y0, auto x1, auto y1, auto x2,
                   auto y2) {
    uint32_t a0[N], b0[N], a1[N], b1[N], a2[N], b2[N], t[N];
    get(a0, x0);
    get(b0, y0);
    get(a1, x1);
    get(b1, y1);
    get(a2, x2);
    get(b2, y2);
    stmt::fdot3(t, a0, b0, a1, b1, a2, b2);
    put(r, t);
  };
  auto fdot4 = [&](auto r, auto x0, auto y0, auto x1, auto y1, auto x2,
                   auto y2, auto x3, auto y3) {
    uint32_t a0[N], b0[N], a1[N], b1[N], a2[N], b2[N], a3[N], b3[N], t[N];
    get(a0, x0);
    get(b0, y0);
    get(a1, x1);
    get(b1, y1);
    get(a2, x2);
    get(b2, y2);
    get(a3, x3);
    get(b3, y3);
    stmt::fdot4(t, a0, b0, a1, b1, a2, b2, a3, b3);
    put(r, t);
  };
  auto fdot5 = [&](auto r, auto x0, auto y0, auto x1, auto y1, auto x2,
                   auto y2, auto x3, auto y3, auto x4, auto y4) {
    uint32_t a0[N], b0[N], a1[N], b1[N], a2[N], b2[N], a3[N], b3[N], a4[N],
        b4[N], t[N];
    get(a0, x0);
    get(b0, y0);
    get(a1, x1);
    get(b1, y1);
    get(a2, x2);
    get(b2, y2);
    get(a3, x3);
    get(b3, y3);
    get(a4, x4);
    get(b4, y4);
    stmt::fdot5(t, a0, b0, a1, b1, a2, b2, a3, b3, a4, b4);
    put(r, t);
  };

  const Park total{park[half][slot]};
  if (half == 0) {
    // ---- the first half of a lane ----
    uint32_t a[N], b[N], c[N], d[N], t[N], u[N], v[N], w[N], x0[N], x3[N],
        one[N], two[N], k0[N], k1[N], k2[N], k3[N], k4[N];
    const Park cd{park[2][slot]};
    const Park x1{park[3][slot]};
    const Park x2{park[4][slot]};

    // arithmetic: (a b q_m + a q_l + b q_r + c q_o + d q_f + q_c) q_arith;
    // and c a b D, which the fixed base needs
    ld(a, k_a);
    ld(b, k_b);
    fmul(t, a, b);             // a b
    ld(c, k_c);
    ld(d, k_d);
    ld(k0, k_q_m);
    ld(k1, k_q_l);
    ld(k2, k_q_r);
    ld(k3, k_q_o);
    ld(k4, k_q_f);
    fdot5(u, t, k0, a, k1, b, k2, c, k3, d, k4);
    tb(k0, t_jubjub_d);
    fmul(t, t, k0);
    fmul(cd, c, t);            // c a b D
    ld(k0, k_q_c);
    fadd(u, u, k0);
    ld(k0, k_q_arith);
    fmul(total, u, k0);

    // fixed-base: bit = d_w - 2d, (bit^3 - bit) + (bit q_c - c) k + (x_lhs -
    // x_rhs) k^2 + (y_lhs - y_rhs) k^3, times the separator and q_fixed
    // (x_beta = q_l, y_beta = q_r)
    tb(one, t_one);
    ld(t, k_d);
    fadd(t, t, t);
    ld(x0, k_d_w);
    fsub(x0, x0, t);           // bit
    fmul(u, x0, x0);           // bit^2
    ld(t, k_q_r);
    fsub(t, t, one);
    fmul(v, u, t);
    fadd(v, v, one);           // y_alpha = bit^2 (q_r - 1) + 1
    fneg(v, v);                // -y_alpha
    fsub(u, u, one);
    fmul(x1, x0, u);           // bit (bit - 1) (bit + 1)
    ld(t, k_q_l);
    fmul(w, x0, t);            // x_alpha = bit q_l
    fneg(w, w);                // -x_alpha
    ld(t, k_q_c);
    fmul(t, x0, t);
    ld(u, k_c);
    fsub(x2, t, u);            // bit q_c - c
    fadd(u, one, cd);          // 1 + c a b D
    fsub(cd, one, cd);         // 1 - c a b D
    ld(a, k_a);
    ld(b, k_b);
    ld(x0, k_a_w);
    fdot3(x3, x0, u, a, v, b, w);   // a_w (1 + c a b D) - a y_alpha - b x_alpha
    ld(x0, k_b_w);
    fdot3(w, x0, cd, b, v, a, w);   // b_w (1 - c a b D) - b y_alpha - a x_alpha
    tb(k0, t_fixed_0);
    tb(k1, t_fixed_1);
    tb(k2, t_fixed_2);
    tb(k3, t_fixed_3);
    fdot4(t, x1, k0, x2, k1, x3, k2, w, k3);
    ld(u, k_q_fixed_group_add);
    fmul(t, t, u);
    fadd(total, total, t);

    // logic, on a_sd = a_w - 4a, b_sd = b_w - 4b, d_sd = d_w - 4d: delta(a_sd)
    // + delta(b_sd) k + delta(d_sd) k^2 + (c - a_sd b_sd) k^3 + X k^4, times
    // the separator and q_logic; X = q_c (9 d_sd - 3 s) + 3 (s + d_sd) - 2 f,
    // s = a_sd + b_sd, f = c (c (4c - 18 s + 81) + 18 (a_sd^2 + b_sd^2) -
    // 81 s + 83).  a_sd and b_sd are formed again for their deltas.
    tb(two, t_two);
    ld(t, k_a);
    ld(x0, k_a_w);
    minus4(x0, x0, t);         // a_sd
    ld(t, k_b);
    ld(w, k_b_w);
    minus4(w, w, t);           // b_sd
    ld(c, k_c);
    fmul(t, x0, w);
    fsub(x1, c, t);            // c - a_sd b_sd
    fadd(u, x0, w);            // s
    fdot2(v, x0, x0, w, w);    // a_sd^2 + b_sd^2
    fadd(w, u, u);             // 2s
    fadd(x0, w, w);
    fadd(x0, x0, x0);
    fadd(x0, x0, x0);          // 16 s
    fadd(x0, x0, w);           // 18 s
    fadd(t, c, c);
    fadd(t, t, t);             // 4c
    fsub(t, t, x0);
    tb(k0, t_eighty_one);
    fadd(t, t, k0);            // 4c - 18 s + 81
    tb(k0, t_eighteen);
    tb(k1, t_neg_eighty_one);
    fdot3(t, c, t, k0, v, k1, u);
    tb(k0, t_eighty_three);
    fadd(t, t, k0);
    fmul(w, c, t);             // f
    ld(t, k_d);
    ld(x0, k_d_w);
    minus4(x0, x0, t);         // d_sd
    fadd(v, u, x0);
    fadd(t, v, v);
    fadd(v, t, v);             // 3 (s + d_sd)
    fadd(t, w, w);
    fsub(w, v, t);             // 3 (s + d_sd) - 2 f
    fadd(t, x0, x0);
    fadd(t, t, t);
    fadd(t, t, t);
    fadd(t, t, x0);            // 9 d_sd
    fadd(v, u, u);
    fadd(v, v, u);             // 3 s
    fsub(t, t, v);
    ld(v, k_q_c);
    fmul(t, v, t);
    fadd(x2, w, t);            // X
    delta(x0, x0, two);        // delta(d_sd)
    ld(t, k_a);
    ld(u, k_a_w);
    minus4(u, u, t);
    delta(u, u, two);          // delta(a_sd)
    ld(t, k_b);
    ld(v, k_b_w);
    minus4(v, v, t);
    delta(v, v, two);          // delta(b_sd)
    tb(k0, t_logic_0);
    tb(k1, t_logic_1);
    tb(k2, t_logic_2);
    tb(k3, t_logic_3);
    tb(k4, t_logic_4);
    fdot5(t, u, k0, v, k1, x0, k2, x1, k3, x2, k4);
    ld(u, k_q_logic);
    fmul(t, t, u);
    fadd(total, total, t);
    // ---- end of the first half of a lane ----
  } else {
    // ---- the second half of a lane ----
    uint32_t a[N], b[N], c[N], d[N], t[N], u[N], v[N], w[N], x0[N], x2[N],
        x3[N], one[N], two[N], k0[N], k1[N], k2[N], k3[N];
    const Park x1{park[5][slot]};

    // variable-base: (a d - d_w) + (d_w + b c - a_w (1 + mix)) k + (b d + a c
    // - b_w (1 - mix)) k^2, mix = d_w b c D, times the separator and q_var
    tb(one, t_one);
    ld(b, k_b);
    ld(c, k_c);
    fmul(u, b, c);             // b c
    tb(k0, t_jubjub_d);
    fmul(t, u, k0);
    ld(w, k_d_w);
    fmul(v, w, t);             // mix
    fadd(t, one, v);
    ld(x0, k_a_w);
    fmul(t, x0, t);
    fadd(x1, w, u);
    fsub(x1, x1, t);           // d_w + b c - a_w (1 + mix)
    fsub(t, v, one);
    ld(a, k_a);
    ld(b, k_b);
    ld(c, k_c);
    ld(d, k_d);
    ld(x0, k_b_w);
    fdot3(x2, b, d, a, c, x0, t);   // b d + a c - b_w (1 - mix)
    fmul(t, a, d);
    ld(w, k_d_w);
    fsub(x0, t, w);            // a d - d_w
    tb(k0, t_var_0);
    tb(k1, t_var_1);
    tb(k2, t_var_2);
    fdot3(t, x0, k0, x1, k1, x2, k2);
    ld(u, k_q_variable_group_add);
    fmul(total, t, u);

    // range: delta(c - 4d) + delta(b - 4c) k + delta(a - 4b) k^2 +
    // delta(d_w - 4a) k^3, times the separator and q_range
    tb(two, t_two);
    ld(c, k_c);
    ld(d, k_d);
    minus4(t, c, d);
    delta(x0, t, two);
    ld(b, k_b);
    ld(c, k_c);
    minus4(t, b, c);
    delta(x1, t, two);
    ld(a, k_a);
    ld(b, k_b);
    minus4(t, a, b);
    delta(x2, t, two);
    ld(d, k_d_w);
    ld(a, k_a);
    minus4(t, d, a);
    delta(x3, t, two);
    tb(k0, t_range_0);
    tb(k1, t_range_1);
    tb(k2, t_range_2);
    tb(k3, t_range_3);
    fdot4(t, x0, k0, x1, k1, x2, k2, x3, k3);
    ld(u, k_q_range);
    fmul(t, t, u);
    fadd(total, total, t);

    // permutation: (a + beta X + gamma) (b + 7 beta X + gamma) (c + 13 beta X
    // + gamma) (d + 17 beta X + gamma) z alpha - (a + beta s1 + gamma) ... (d
    // + beta s4 + gamma) z_w alpha + (z - 1) L1 alpha^2 (K1, K2, K3 = 7, 13,
    // 17: additions)
    ld(u, k_linear);           // X
    tb(k0, t_beta);
    fmul(u, u, k0);            // beta X
    tb(k3, t_gamma);
    fadd(v, u, u);
    fadd(v, v, v);
    fadd(v, v, v);             // 8 beta X
    ld(a, k_a);
    fadd(t, u, a);
    fadd(x0, t, k3);
    fsub(t, v, u);             // 7 beta X
    ld(b, k_b);
    fadd(t, t, b);
    fadd(x2, t, k3);
    fmul(x0, x0, x2);
    fadd(w, u, u);
    fadd(w, w, w);             // 4 beta X
    fadd(t, v, w);
    fadd(t, t, u);             // 13 beta X
    ld(c, k_c);
    fadd(t, t, c);
    fadd(x2, t, k3);
    fmul(x0, x0, x2);
    fadd(t, v, v);
    fadd(t, t, u);             // 17 beta X
    ld(d, k_d);
    fadd(t, t, d);
    fadd(x2, t, k3);
    fmul(x0, x0, x2);          // the identity's product
    ld(u, k_z);
    fmul(x0, x0, u);           // times z
    fsub(x3, u, one);          // z - 1
    ld(u, k_s_sigma_1);
    fmul(t, u, k0);
    ld(a, k_a);
    fadd(t, t, a);
    fadd(x1, t, k3);
    ld(u, k_s_sigma_2);
    fmul(t, u, k0);
    ld(b, k_b);
    fadd(t, t, b);
    fadd(x2, t, k3);
    fmul(x1, x1, x2);
    ld(u, k_s_sigma_3);
    fmul(t, u, k0);
    ld(c, k_c);
    fadd(t, t, c);
    fadd(x2, t, k3);
    fmul(x1, x1, x2);
    ld(u, k_s_sigma_4);
    fmul(t, u, k0);
    ld(d, k_d);
    fadd(t, t, d);
    fadd(x2, t, k3);
    fmul(x1, x1, x2);          // the copy's product
    ld(u, k_z_w);
    fmul(x1, x1, u);           // times z_w
    ld(v, k_l1_alpha_sq);
    tb(k1, t_alpha);
    tb(k2, t_neg_alpha);
    fdot3(t, x0, k1, x1, k2, x3, v);
    fadd(total, total, t);
    // ---- end of the second half of a lane ----
  }
  __syncthreads();
  if (half == 1) {
    uint32_t t[N], u[N];
    // ---- the combine ----
    meet(t);                   // the first half's sum
    fadd(total, total, t);
    ld(u, k_pi);
    fadd(total, total, u);
    ld(u, k_v_h_inv);
    fmul(total, total, u);
    st(total);
    // ---- end of the combine ----
  }
}

}  // namespace

// The quotient of `lanes` lanes: `in` the kOperands operand pointers in
// the order of `enum Operand`, `limb_stride` the distance between their limb
// rows in elements (the lanes of a row contiguous), `table` the [kEntries,
// 8] challenge table on the card (copied to constant memory on `stream`),
// `out` an [8, lanes] output.  Returns the first CUDA error.
extern "C" int zk_quotient(const void* const* in, const long long* limb_stride,
                           const void* table, void* out, long long lanes,
                           void* stream) {
  Operands ops;
  for (int k = 0; k < kOperands; ++k) {
    ops.p[k] = (const uint32_t*)in[k];
    ops.limb_stride[k] = limb_stride[k];
  }
  // the SM's shared memory at its largest, so that kBlocksPerSm blocks of
  // `park` and `stage` fit whatever the carveout of the launch before
  cudaError_t err = cudaFuncSetAttribute(
      quotient_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(
      c_table, table, sizeof(c_table), 0, cudaMemcpyDeviceToDevice,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = zk::blocks_for(lanes, kPairs);
  quotient_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ops, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
