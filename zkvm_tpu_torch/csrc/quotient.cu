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
// separator folded into its widget's powers -- as long as every value it
// keeps is canonical: each product is reduced below r (fr_lazy.cuh's `mul`
// lands below 1.453 r, `reduce_dot` takes a dot product of up to five pairs
// to [0, r)), and each sum and difference stays in [0, r) (`add_r`, `sub_r`).
// Every output word then equals the chain's.
//
// Design for the card:
//   * one thread a lane.  Row l of an [8, L] operand is contiguous across
//     lanes, so a warp's loads of one limb coalesce; each of the 28 inputs is
//     read once, the output written once;
//   * a lane is a long chain of carry-flag arithmetic, and a thread's chains
//     cannot overlap (one flag), so the warps an SM holds set the pace:
//     blocks of 128 threads, four an SM, 128 registers a thread and ~1 KB
//     spilled, ran at 1.504 ms on an H100 at [8, 2^19] against 2.033 ms at
//     two blocks (255 registers, 76 bytes spilled), 1.797 at three and
//     1.695 at five (tools/quotient_bounds.py);
//   * the widgets run in the order arithmetic, fixed-base, logic,
//     variable-base, range, permutation, each summed into `total` as it
//     ends, so that q_l and q_r die after the fixed base, q_c after the
//     logic widget and the shifted wires a_w, b_w, d_w before the
//     permutation;
//   * the challenges' powers come from a small table the wrapper builds on
//     the host (`ops/quotient_kernel.py`, `challenge_table`), one entry of 8
//     words read by every thread at the same address; the products by 2, 3,
//     4, 9, 18 s and the permutation's K1, K2, K3 (7, 13, 17) are
//     additions;
//   * sums of products are Montgomery dot products of two to five pairs: one
//     reduction instead of one a product.  A lane takes 49 products and 11
//     dot products (`kernels.quotient_multiply_adds`: 19,776 32-bit
//     multiply-adds), where the chain takes 113 products of full width
//     (30,736).
//
// The program of a lane (between the markers in `quotient_kernel`) and the
// two functions it calls are written in eight statements only -- ld, tb,
// st, fmul, fadd, fsub, fneg, fdot2 .. fdot5 -- so that the CPU model
// (`tests/test_torch_quotient_design.py`) reads it from here and executes it
// on the carry chains of fr_lazy.cuh.
#include "common.cuh"
#include "fr_lazy.cuh"

namespace {

constexpr int N = zk::Fr::N;
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 4;

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

// ---- the statements (canonical operands and results) ----------------------

// r = a b / R mod r.  r may alias a or b.
__device__ __forceinline__ void fmul(uint32_t* r, const uint32_t* a,
                                     const uint32_t* b) {
  zk::frl::mul(r, a, b);  // a canonical: below 1.453 r
  zk::frl::reduce_r(r);
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

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
quotient_kernel(const Operands in, const uint32_t* __restrict__ table,
                uint32_t* __restrict__ out, long long lanes) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  // operand k of this lane; entry k of the table; the output
  auto ld = [&](uint32_t* x, int k) {
#pragma unroll
    for (int l = 0; l < N; ++l)
      x[l] = __ldg(in.p[k] + l * in.limb_stride[k] + lane);
  };
  auto tb = [&](uint32_t* x, int k) {
#pragma unroll
    for (int l = 0; l < N; ++l) x[l] = __ldg(table + k * N + l);
  };
  auto st = [&](const uint32_t* x) {
#pragma unroll
    for (int l = 0; l < N; ++l) out[l * lanes + lane] = x[l];
  };

  // ---- the program of a lane ----
  uint32_t a[N], b[N], c[N], d[N], aw[N], bw[N], dw[N], qc[N], one[N],
      two[N], total[N], ab[N], t[N], u[N], v[N], w[N], x0[N], x1[N], x2[N],
      x3[N], x4[N], k0[N], k1[N], k2[N], k3[N], k4[N];
  ld(a, k_a);
  ld(b, k_b);
  ld(c, k_c);
  ld(d, k_d);
  ld(qc, k_q_c);

  // arithmetic: (a b q_m + a q_l + b q_r + c q_o + d q_f + q_c) q_arith
  fmul(ab, a, b);
  ld(k0, k_q_m);
  ld(k1, k_q_l);
  ld(k2, k_q_r);
  ld(k3, k_q_o);
  ld(k4, k_q_f);
  fdot5(t, ab, k0, a, k1, b, k2, c, k3, d, k4);
  fadd(t, t, qc);
  ld(k0, k_q_arith);
  fmul(total, t, k0);

  // fixed-base: bit = d_w - 2d, (bit^3 - bit) + (bit q_c - c) k + (x_lhs -
  // x_rhs) k^2 + (y_lhs - y_rhs) k^3, times the separator and q_fixed
  // (x_beta = q_l, y_beta = q_r)
  ld(aw, k_a_w);
  ld(bw, k_b_w);
  ld(dw, k_d_w);
  tb(one, t_one);
  fadd(t, d, d);
  fsub(x0, dw, t);           // bit
  fmul(u, x0, x0);           // bit^2
  fsub(t, u, one);
  fmul(x1, x0, t);           // bit (bit - 1) (bit + 1)
  fsub(t, k2, one);
  fmul(v, u, t);
  fadd(v, v, one);           // y_alpha = bit^2 (q_r - 1) + 1
  fmul(w, x0, k1);           // x_alpha = bit q_l
  fmul(t, x0, qc);
  fsub(x2, t, c);            // bit q_c - c
  fneg(v, v);                // -y_alpha
  fneg(w, w);                // -x_alpha
  tb(k0, t_jubjub_d);
  fmul(t, ab, k0);
  fmul(t, c, t);             // c a b D
  fadd(u, one, t);
  fdot3(x3, aw, u, a, v, b, w);   // a_w (1 + c a b D) - a y_alpha - b x_alpha
  fsub(u, one, t);
  fdot3(x4, bw, u, b, v, a, w);   // b_w (1 - c a b D) - b y_alpha - a x_alpha
  tb(k0, t_fixed_0);
  tb(k1, t_fixed_1);
  tb(k2, t_fixed_2);
  tb(k3, t_fixed_3);
  fdot4(t, x1, k0, x2, k1, x3, k2, x4, k3);
  ld(k0, k_q_fixed_group_add);
  fmul(t, t, k0);
  fadd(total, total, t);

  // logic, on a_sd = a_w - 4a, b_sd = b_w - 4b, d_sd = d_w - 4d: delta(a_sd)
  // + delta(b_sd) k + delta(d_sd) k^2 + (c - a_sd b_sd) k^3 + X k^4, times
  // the separator and q_logic; X = q_c (9 d_sd - 3 s) + 3 (s + d_sd) - 2 f,
  // s = a_sd + b_sd, f = c (c (4c - 18 s + 81) + 18 (a_sd^2 + b_sd^2) -
  // 81 s + 83)
  tb(two, t_two);
  minus4(x0, aw, a);         // a_sd
  minus4(x1, bw, b);         // b_sd
  minus4(x2, dw, d);         // d_sd
  fmul(t, x0, x1);
  fsub(x3, c, t);            // c - a_sd b_sd
  fadd(u, x0, x1);           // s
  fdot2(v, x0, x0, x1, x1);  // a_sd^2 + b_sd^2
  delta(x0, x0, two);
  delta(x1, x1, two);
  fadd(w, u, u);             // 2s
  fadd(x4, w, w);
  fadd(x4, x4, x4);
  fadd(x4, x4, x4);          // 16 s
  fadd(x4, x4, w);           // 18 s
  fadd(t, c, c);
  fadd(t, t, t);             // 4c
  fsub(t, t, x4);
  tb(k0, t_eighty_one);
  fadd(t, t, k0);            // 4c - 18 s + 81
  tb(k0, t_eighteen);
  tb(k1, t_neg_eighty_one);
  fdot3(t, c, t, k0, v, k1, u);
  tb(k0, t_eighty_three);
  fadd(t, t, k0);
  fmul(w, c, t);             // f
  fadd(v, u, x2);
  fadd(x4, v, v);
  fadd(x4, x4, v);           // 3 (s + d_sd)
  fadd(t, w, w);
  fsub(x4, x4, t);           // 3 (s + d_sd) - 2 f
  fadd(t, x2, x2);
  fadd(t, t, t);
  fadd(t, t, t);
  fadd(t, t, x2);            // 9 d_sd
  fadd(v, u, u);
  fadd(v, v, u);             // 3 s
  fsub(t, t, v);
  fmul(t, qc, t);
  fadd(x4, x4, t);           // X
  delta(x2, x2, two);
  tb(k0, t_logic_0);
  tb(k1, t_logic_1);
  tb(k2, t_logic_2);
  tb(k3, t_logic_3);
  tb(k4, t_logic_4);
  fdot5(t, x0, k0, x1, k1, x2, k2, x3, k3, x4, k4);
  ld(k0, k_q_logic);
  fmul(t, t, k0);
  fadd(total, total, t);

  // variable-base: (a d - d_w) + (d_w + b c - a_w (1 + mix)) k + (b d + a c
  // - b_w (1 - mix)) k^2, mix = d_w b c D, times the separator and q_var
  fmul(u, b, c);             // y1 x2
  tb(k0, t_jubjub_d);
  fmul(t, u, k0);
  fmul(v, dw, t);            // mix
  fmul(t, a, d);
  fsub(x0, t, dw);
  fadd(t, one, v);
  fmul(t, aw, t);
  fadd(x1, dw, u);
  fsub(x1, x1, t);
  fsub(t, v, one);
  fdot3(x2, b, d, a, c, bw, t);
  tb(k0, t_var_0);
  tb(k1, t_var_1);
  tb(k2, t_var_2);
  fdot3(t, x0, k0, x1, k1, x2, k2);
  ld(k0, k_q_variable_group_add);
  fmul(t, t, k0);
  fadd(total, total, t);

  // range: delta(c - 4d) + delta(b - 4c) k + delta(a - 4b) k^2 +
  // delta(d_w - 4a) k^3, times the separator and q_range
  minus4(t, c, d);
  delta(x0, t, two);
  minus4(t, b, c);
  delta(x1, t, two);
  minus4(t, a, b);
  delta(x2, t, two);
  minus4(t, dw, a);
  delta(x3, t, two);
  tb(k0, t_range_0);
  tb(k1, t_range_1);
  tb(k2, t_range_2);
  tb(k3, t_range_3);
  fdot4(t, x0, k0, x1, k1, x2, k2, x3, k3);
  ld(k0, k_q_range);
  fmul(t, t, k0);
  fadd(total, total, t);

  // permutation: (a + beta X + gamma) (b + 7 beta X + gamma) (c + 13 beta X
  // + gamma) (d + 17 beta X + gamma) z alpha - (a + beta s1 + gamma) ... (d
  // + beta s4 + gamma) z_w alpha + (z - 1) L1 alpha^2 (K1, K2, K3 = 7, 13,
  // 17: additions); then the public inputs, and the product by Z_H^-1
  ld(u, k_linear);           // X
  tb(k0, t_beta);
  fmul(u, u, k0);            // beta X
  tb(k4, t_gamma);
  fadd(v, u, u);
  fadd(v, v, v);
  fadd(v, v, v);             // 8 beta X
  fadd(t, u, a);
  fadd(x0, t, k4);
  fsub(t, v, u);             // 7 beta X
  fadd(t, t, b);
  fadd(x1, t, k4);
  fmul(x0, x0, x1);
  fadd(w, u, u);
  fadd(w, w, w);             // 4 beta X
  fadd(t, v, w);
  fadd(t, t, u);             // 13 beta X
  fadd(t, t, c);
  fadd(x1, t, k4);
  fmul(x0, x0, x1);
  fadd(t, v, v);
  fadd(t, t, u);             // 17 beta X
  fadd(t, t, d);
  fadd(x1, t, k4);
  fmul(x0, x0, x1);          // the identity's product
  ld(u, k_s_sigma_1);
  fmul(t, u, k0);
  fadd(t, t, a);
  fadd(x1, t, k4);
  ld(u, k_s_sigma_2);
  fmul(t, u, k0);
  fadd(t, t, b);
  fadd(x2, t, k4);
  fmul(x1, x1, x2);
  ld(u, k_s_sigma_3);
  fmul(t, u, k0);
  fadd(t, t, c);
  fadd(x2, t, k4);
  fmul(x1, x1, x2);
  ld(u, k_s_sigma_4);
  fmul(t, u, k0);
  fadd(t, t, d);
  fadd(x2, t, k4);
  fmul(x1, x1, x2);          // the copy's product
  ld(u, k_z);
  tb(k1, t_alpha);
  fmul(x2, u, k1);           // z alpha
  fsub(x3, u, one);          // z - 1
  ld(u, k_z_w);
  tb(k1, t_neg_alpha);
  fmul(u, u, k1);            // -z_w alpha
  ld(v, k_l1_alpha_sq);
  fdot3(t, x0, x2, x1, u, x3, v);
  fadd(total, total, t);
  ld(u, k_pi);
  fadd(total, total, u);
  ld(u, k_v_h_inv);
  fmul(total, total, u);
  st(total);
  // ---- end of the program of a lane ----
}

}  // namespace

// The quotient of `lanes` lanes: `in` the kOperands operand pointers in
// the order of `enum Operand`, `limb_stride` the distance between their limb
// rows in elements (the lanes of a row contiguous), `table` the [kEntries,
// 8] challenge table, `out` an [8, lanes] output.  Returns
// cudaGetLastError().
extern "C" int zk_quotient(const void* const* in, const long long* limb_stride,
                           const void* table, void* out, long long lanes,
                           void* stream) {
  Operands ops;
  for (int k = 0; k < kOperands; ++k) {
    ops.p[k] = (const uint32_t*)in[k];
    ops.limb_stride[k] = limb_stride[k];
  }
  const unsigned grid = zk::blocks_for(lanes, kThreads);
  quotient_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ops, (const uint32_t*)table, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
