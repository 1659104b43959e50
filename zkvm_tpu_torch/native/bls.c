/* Native host-side BLS12-381 arithmetic: Montgomery Fp (6x u64, CIOS),
 * Fp2/Fp6/Fp12 tower, Jacobian G1, Pippenger MSM (OpenMP over windows),
 * Miller loop + cyclotomic final exponentiation.
 *
 * This is the host runtime complement to the TPU kernels: the verifier's
 * two small MSMs and one pairing check are latency-bound host work (the
 * reference runs them in native Rust, proof.rs:335-401 / pairings.rs), so
 * they run here in C instead of Python big-ints.  Formulas are ports of
 * this repo's own exact-int implementations (curves/fast_tower.py,
 * curves/weierstrass.py semantics); results are bit-identical and pinned
 * by tests/test_native.py against the Python tower and relic vectors.
 *
 * ABI: little-endian 48-byte field elements; fp2 = c0||c1; G1 affine =
 * x||y (96 bytes, x=y=0 encodes infinity); G2 affine = x||y (192 bytes);
 * fp12 = 12 fp limbs in tower order c0.c0.c0 .. c1.c2.c1 (576 bytes);
 * scalars = 32-byte LE.
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

typedef struct { u64 l[6]; } fp;

static const fp FP_P = {{0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
                         0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                         0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL}};
static const fp FP_R2 = {{0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
                          0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
                          0x9a793e85b519952dULL, 0x11988fe592cae3aaULL}};
static const fp FP_ONE = {{0x760900000002fffdULL, 0xebf4000bc40c0002ULL,
                           0x5f48985753c758baULL, 0x77ce585370525745ULL,
                           0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL}};
static const u64 FP_INV = 0x89f3fffcfffcfffdULL;
static const u64 BLS_X = 0xd201000000010000ULL; /* |x|, x negative */

static inline int fp_is_zero(const fp *a) {
    u64 t = 0;
    for (int i = 0; i < 6; i++) t |= a->l[i];
    return t == 0;
}

static inline int fp_eq(const fp *a, const fp *b) {
    u64 t = 0;
    for (int i = 0; i < 6; i++) t |= a->l[i] ^ b->l[i];
    return t == 0;
}

static inline int fp_gte_p(const fp *a) {
    for (int i = 5; i >= 0; i--) {
        if (a->l[i] > FP_P.l[i]) return 1;
        if (a->l[i] < FP_P.l[i]) return 0;
    }
    return 1;
}

static inline void fp_sub_p(fp *a) {
    u128 bor = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a->l[i] - FP_P.l[i] - bor;
        a->l[i] = (u64)d;
        bor = (d >> 64) & 1;
    }
}

static inline void fp_add(fp *r, const fp *a, const fp *b) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
        c += (u128)a->l[i] + b->l[i];
        r->l[i] = (u64)c;
        c >>= 64;
    }
    if (c || fp_gte_p(r)) fp_sub_p(r);
}

static inline void fp_sub(fp *r, const fp *a, const fp *b) {
    u128 bor = 0;
    fp t;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a->l[i] - b->l[i] - bor;
        t.l[i] = (u64)d;
        bor = (d >> 64) & 1;
    }
    if (bor) {
        u128 c = 0;
        for (int i = 0; i < 6; i++) {
            c += (u128)t.l[i] + FP_P.l[i];
            t.l[i] = (u64)c;
            c >>= 64;
        }
    }
    *r = t;
}

static inline void fp_neg(fp *r, const fp *a) {
    if (fp_is_zero(a)) { *r = *a; return; }
    u128 bor = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)FP_P.l[i] - a->l[i] - bor;
        r->l[i] = (u64)d;
        bor = (d >> 64) & 1;
    }
}

static inline void fp_dbl(fp *r, const fp *a) { fp_add(r, a, a); }

/* CIOS Montgomery multiplication */
static void fp_mul(fp *r, const fp *a, const fp *b) {
    u64 t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u128 c = 0;
        u64 ai = a->l[i];
        for (int j = 0; j < 6; j++) {
            c = (u128)ai * b->l[j] + t[j] + (u64)c;
            t[j] = (u64)c;
            c >>= 64;
        }
        c = (u128)t[6] + (u64)c;
        t[6] = (u64)c;
        t[7] = (u64)(c >> 64);
        u64 m = t[0] * FP_INV;
        c = (u128)m * FP_P.l[0] + t[0];
        c >>= 64;
        for (int j = 1; j < 6; j++) {
            c = (u128)m * FP_P.l[j] + t[j] + (u64)c;
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c = (u128)t[6] + (u64)c;
        t[5] = (u64)c;
        t[6] = t[7] + (u64)(c >> 64);
    }
    memcpy(r->l, t, 48);
    if (t[6] || fp_gte_p(r)) fp_sub_p(r);
}

static inline void fp_sqr(fp *r, const fp *a) { fp_mul(r, a, a); }

static void fp_inv(fp *r, const fp *a) {
    /* Fermat: a^(p-2); p-2 streamed MSB-first */
    static const u64 PM2[6] = {0xb9feffffffffaaa9ULL, 0x1eabfffeb153ffffULL,
                               0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                               0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
    fp acc = FP_ONE;
    int started = 0;
    for (int w = 5; w >= 0; w--)
        for (int b = 63; b >= 0; b--) {
            if (started) fp_sqr(&acc, &acc);
            if ((PM2[w] >> b) & 1) {
                if (started) fp_mul(&acc, &acc, a);
                else { acc = *a; started = 1; }
            }
        }
    *r = acc;
}

static void fp_from_bytes(fp *r, const uint8_t *in) {
    fp t;
    for (int i = 0; i < 6; i++) {
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | in[i * 8 + j];
        t.l[i] = v;
    }
    fp_mul(r, &t, &FP_R2); /* to Montgomery */
}

static void fp_to_bytes(uint8_t *out, const fp *a) {
    fp one = {{1, 0, 0, 0, 0, 0}}, t;
    fp_mul(&t, a, &one); /* from Montgomery */
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (uint8_t)(t.l[i] >> (8 * j));
}

/* ---------------- fp2: u^2 = -1 ---------------- */

typedef struct { fp c0, c1; } fp2;

static inline void fp2_add(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_add(&r->c0, &a->c0, &b->c0);
    fp_add(&r->c1, &a->c1, &b->c1);
}

static inline void fp2_sub(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_sub(&r->c0, &a->c0, &b->c0);
    fp_sub(&r->c1, &a->c1, &b->c1);
}

static inline void fp2_neg(fp2 *r, const fp2 *a) {
    fp_neg(&r->c0, &a->c0);
    fp_neg(&r->c1, &a->c1);
}

static inline void fp2_dbl(fp2 *r, const fp2 *a) { fp2_add(r, a, a); }

static void fp2_mul(fp2 *r, const fp2 *a, const fp2 *b) {
    fp t0, t1, s0, s1, d0, d1;
    fp_mul(&t0, &a->c0, &b->c0);
    fp_mul(&t1, &a->c1, &b->c1);
    fp_add(&s0, &a->c0, &a->c1);
    fp_add(&s1, &b->c0, &b->c1);
    fp_mul(&d1, &s0, &s1);
    fp_sub(&d1, &d1, &t0);
    fp_sub(&d1, &d1, &t1);
    fp_sub(&d0, &t0, &t1);
    r->c0 = d0;
    r->c1 = d1;
}

static void fp2_sqr(fp2 *r, const fp2 *a) {
    fp s, d, m;
    fp_add(&s, &a->c0, &a->c1);
    fp_sub(&d, &a->c0, &a->c1);
    fp_mul(&m, &a->c0, &a->c1);
    fp_mul(&r->c0, &s, &d);
    fp_dbl(&r->c1, &m);
}

/* * (u + 1) */
static inline void fp2_mul_by_nonres(fp2 *r, const fp2 *a) {
    fp t0, t1;
    fp_sub(&t0, &a->c0, &a->c1);
    fp_add(&t1, &a->c0, &a->c1);
    r->c0 = t0;
    r->c1 = t1;
}

static inline void fp2_conj(fp2 *r, const fp2 *a) {
    r->c0 = a->c0;
    fp_neg(&r->c1, &a->c1);
}

static void fp2_inv(fp2 *r, const fp2 *a) {
    fp t0, t1, n, ni;
    fp_sqr(&t0, &a->c0);
    fp_sqr(&t1, &a->c1);
    fp_add(&n, &t0, &t1);
    fp_inv(&ni, &n);
    fp_mul(&r->c0, &a->c0, &ni);
    fp_mul(&t0, &a->c1, &ni);
    fp_neg(&r->c1, &t0);
}

static inline void fp2_mul_fp(fp2 *r, const fp2 *a, const fp *s) {
    fp_mul(&r->c0, &a->c0, s);
    fp_mul(&r->c1, &a->c1, s);
}

static inline int fp2_is_zero(const fp2 *a) {
    return fp_is_zero(&a->c0) && fp_is_zero(&a->c1);
}

/* ---------------- fp6: v^3 = u + 1 ---------------- */

typedef struct { fp2 c0, c1, c2; } fp6;

static inline void fp6_add(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2_add(&r->c0, &a->c0, &b->c0);
    fp2_add(&r->c1, &a->c1, &b->c1);
    fp2_add(&r->c2, &a->c2, &b->c2);
}

static inline void fp6_sub(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2_sub(&r->c0, &a->c0, &b->c0);
    fp2_sub(&r->c1, &a->c1, &b->c1);
    fp2_sub(&r->c2, &a->c2, &b->c2);
}

static inline void fp6_neg(fp6 *r, const fp6 *a) {
    fp2_neg(&r->c0, &a->c0);
    fp2_neg(&r->c1, &a->c1);
    fp2_neg(&r->c2, &a->c2);
}

static void fp6_mul(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2 t0, t1, t2, s, u, x, y, z;
    fp2_mul(&t0, &a->c0, &b->c0);
    fp2_mul(&t1, &a->c1, &b->c1);
    fp2_mul(&t2, &a->c2, &b->c2);
    fp2_add(&s, &a->c1, &a->c2);
    fp2_add(&u, &b->c1, &b->c2);
    fp2_mul(&x, &s, &u);
    fp2_sub(&x, &x, &t1);
    fp2_sub(&x, &x, &t2);
    fp2_mul_by_nonres(&x, &x);
    fp2_add(&x, &x, &t0);
    fp2_add(&s, &a->c0, &a->c1);
    fp2_add(&u, &b->c0, &b->c1);
    fp2_mul(&y, &s, &u);
    fp2_sub(&y, &y, &t0);
    fp2_sub(&y, &y, &t1);
    fp2 nr2;
    fp2_mul_by_nonres(&nr2, &t2);
    fp2_add(&y, &y, &nr2);
    fp2_add(&s, &a->c0, &a->c2);
    fp2_add(&u, &b->c0, &b->c2);
    fp2_mul(&z, &s, &u);
    fp2_sub(&z, &z, &t0);
    fp2_sub(&z, &z, &t2);
    fp2_add(&z, &z, &t1);
    r->c0 = x;
    r->c1 = y;
    r->c2 = z;
}

static void fp6_mul_by_01(fp6 *r, const fp6 *a, const fp2 *b0,
                          const fp2 *b1) {
    fp2 t0, t1, s, u, x, y, z;
    fp2_mul(&t0, &a->c0, b0);
    fp2_mul(&t1, &a->c1, b1);
    fp2_add(&s, &a->c1, &a->c2);
    fp2_mul(&x, &s, b1);
    fp2_sub(&x, &x, &t1);
    fp2_mul_by_nonres(&x, &x);
    fp2_add(&x, &x, &t0);
    fp2_add(&s, &a->c0, &a->c1);
    fp2_add(&u, b0, b1);
    fp2_mul(&y, &u, &s);
    fp2_sub(&y, &y, &t0);
    fp2_sub(&y, &y, &t1);
    fp2_mul(&z, &a->c2, b0);
    fp2_add(&z, &z, &t1);
    r->c0 = x;
    r->c1 = y;
    r->c2 = z;
}

static void fp6_mul_by_1(fp6 *r, const fp6 *a, const fp2 *b1) {
    fp2 t1, s, x, y, z;
    fp2_mul(&t1, &a->c1, b1);
    fp2_add(&s, &a->c1, &a->c2);
    fp2_mul(&x, &s, b1);
    fp2_sub(&x, &x, &t1);
    fp2_mul_by_nonres(&x, &x);
    fp2_mul(&y, &a->c0, b1);
    z = t1;
    r->c0 = x;
    r->c1 = y;
    r->c2 = z;
}

static inline void fp6_mul_by_nonres(fp6 *r, const fp6 *a) {
    fp2 t;
    fp2_mul_by_nonres(&t, &a->c2);
    fp2 c1 = a->c0, c2 = a->c1;
    r->c0 = t;
    r->c1 = c1;
    r->c2 = c2;
}

static void fp6_inv(fp6 *r, const fp6 *a) {
    fp2 c0, c1, c2, t, u;
    fp2_sqr(&c0, &a->c0);
    fp2_mul(&t, &a->c1, &a->c2);
    fp2_mul_by_nonres(&t, &t);
    fp2_sub(&c0, &c0, &t);
    fp2_sqr(&c1, &a->c2);
    fp2_mul_by_nonres(&c1, &c1);
    fp2_mul(&t, &a->c0, &a->c1);
    fp2_sub(&c1, &c1, &t);
    fp2_sqr(&c2, &a->c1);
    fp2_mul(&t, &a->c0, &a->c2);
    fp2_sub(&c2, &c2, &t);
    fp2_mul(&t, &a->c2, &c1);
    fp2_mul(&u, &a->c1, &c2);
    fp2_add(&t, &t, &u);
    fp2_mul_by_nonres(&t, &t);
    fp2_mul(&u, &a->c0, &c0);
    fp2_add(&t, &t, &u);
    fp2_inv(&t, &t);
    fp2_mul(&r->c0, &c0, &t);
    fp2_mul(&r->c1, &c1, &t);
    fp2_mul(&r->c2, &c2, &t);
}

/* Frobenius coefficients: (u+1)^((p-1)/3), (u+1)^(2(p-1)/3),
 * (u+1)^((p-1)/6) -- generated by
 * zkvm_tpu_torch/tools/gen_native_frob.py */
static const fp2 FROB6_C1 = {
    {{0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL}},
    {{0xcd03c9e48671f071ULL, 0x5dab22461fcda5d2ULL, 0x587042afd3851b95ULL, 0x8eb60ebe01bacb9eULL, 0x03f97d6e83d050d2ULL, 0x18f0206554638741ULL}}};
static const fp2 FROB6_C2 = {
    {{0x890dc9e4867545c3ULL, 0x2af322533285a5d5ULL, 0x50880866309b7e2cULL, 0xa20d1b8c7e881024ULL, 0x14e4f04fe2db9068ULL, 0x14e56d3f1564853aULL}},
    {{0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL}}};
static const fp2 FROB12_C1 = {
    {{0x07089552b319d465ULL, 0xc6695f92b50a8313ULL, 0x97e83cccd117228fULL, 0xa35baecab2dc29eeULL, 0x1ce393ea5daace4dULL, 0x08f2220fb0fb66ebULL}},
    {{0xb2f66aad4ce5d646ULL, 0x5842a06bfc497cecULL, 0xcf4895d42599d394ULL, 0xc11b9cba40a8e8d0ULL, 0x2e3813cbe5a0de89ULL, 0x110eefda88847fafULL}}};

static void fp6_frob(fp6 *r, const fp6 *a) {
    fp2 t;
    fp2_conj(&r->c0, &a->c0);
    fp2_conj(&t, &a->c1);
    fp2_mul(&r->c1, &t, &FROB6_C1);
    fp2_conj(&t, &a->c2);
    fp2_mul(&r->c2, &t, &FROB6_C2);
}

/* ---------------- fp12: w^2 = v ---------------- */

typedef struct { fp6 c0, c1; } fp12;

static void fp12_mul(fp12 *r, const fp12 *a, const fp12 *b) {
    fp6 aa, bb, s, u, x, y;
    fp6_mul(&aa, &a->c0, &b->c0);
    fp6_mul(&bb, &a->c1, &b->c1);
    fp6_add(&s, &a->c1, &a->c0);
    fp6_add(&u, &b->c0, &b->c1);
    fp6_mul(&y, &s, &u);
    fp6_sub(&y, &y, &aa);
    fp6_sub(&y, &y, &bb);
    fp6_mul_by_nonres(&x, &bb);
    fp6_add(&x, &x, &aa);
    r->c0 = x;
    r->c1 = y;
}

static void fp12_sqr(fp12 *r, const fp12 *a) {
    fp6 ab, s, u, x;
    fp6_mul(&ab, &a->c0, &a->c1);
    fp6_mul_by_nonres(&s, &a->c1);
    fp6_add(&s, &s, &a->c0);
    fp6_add(&u, &a->c0, &a->c1);
    fp6_mul(&x, &s, &u);
    fp6_sub(&x, &x, &ab);
    fp6 nr;
    fp6_mul_by_nonres(&nr, &ab);
    fp6_sub(&x, &x, &nr);
    r->c0 = x;
    fp6_add(&r->c1, &ab, &ab);
}

static void fp12_mul_by_014(fp12 *r, const fp12 *f, const fp2 *c0,
                            const fp2 *c1, const fp2 *c4) {
    fp6 aa, bb, s, x, y;
    fp2 o;
    fp6_mul_by_01(&aa, &f->c0, c0, c1);
    fp6_mul_by_1(&bb, &f->c1, c4);
    fp2_add(&o, c1, c4);
    fp6_add(&s, &f->c1, &f->c0);
    fp6_mul_by_01(&y, &s, c0, &o);
    fp6_sub(&y, &y, &aa);
    fp6_sub(&y, &y, &bb);
    fp6_mul_by_nonres(&x, &bb);
    fp6_add(&x, &x, &aa);
    r->c0 = x;
    r->c1 = y;
}

static inline void fp12_conj(fp12 *r, const fp12 *a) {
    r->c0 = a->c0;
    fp6_neg(&r->c1, &a->c1);
}

static void fp12_frob(fp12 *r, const fp12 *a) {
    fp6 t0, t1;
    fp6_frob(&t0, &a->c0);
    fp6_frob(&t1, &a->c1);
    fp2_mul(&t1.c0, &t1.c0, &FROB12_C1);
    fp2_mul(&t1.c1, &t1.c1, &FROB12_C1);
    fp2_mul(&t1.c2, &t1.c2, &FROB12_C1);
    r->c0 = t0;
    r->c1 = t1;
}

static void fp12_inv(fp12 *r, const fp12 *a) {
    fp6 t0, t1;
    fp6_mul(&t0, &a->c0, &a->c0);
    fp6_mul(&t1, &a->c1, &a->c1);
    fp6_mul_by_nonres(&t1, &t1);
    fp6_sub(&t0, &t0, &t1);
    fp6_inv(&t0, &t0);
    fp6_mul(&r->c0, &a->c0, &t0);
    fp6_mul(&t1, &a->c1, &t0);
    fp6_neg(&r->c1, &t1);
}

static void fp12_one(fp12 *r) {
    memset(r, 0, sizeof(*r));
    r->c0.c0.c0 = FP_ONE;
}

static int fp12_is_one(const fp12 *a) {
    fp12 one;
    fp12_one(&one);
    const u64 *x = (const u64 *)a, *y = (const u64 *)&one;
    u64 t = 0;
    for (size_t i = 0; i < sizeof(fp12) / 8; i++) t |= x[i] ^ y[i];
    return t == 0;
}

/* ---------------- cyclotomic final exponentiation ---------------- */

static void fp4_sq(fp2 *c0, fp2 *c1, const fp2 *a, const fp2 *b) {
    fp2 t0, t1, t2, s;
    fp2_sqr(&t0, a);
    fp2_sqr(&t1, b);
    fp2_mul_by_nonres(&t2, &t1);
    fp2_add(c0, &t2, &t0);
    fp2_add(&s, a, b);
    fp2_sqr(&t2, &s);
    fp2_sub(&t2, &t2, &t0);
    fp2_sub(c1, &t2, &t1);
}

static void cyclo_sq(fp12 *r, const fp12 *f) {
    fp2 z0 = f->c0.c0, z4 = f->c0.c1, z3 = f->c0.c2;
    fp2 z2 = f->c1.c0, z1 = f->c1.c1, z5 = f->c1.c2;
    fp2 t0, t1, t2, t3;
    fp4_sq(&t0, &t1, &z0, &z1);
    fp2_sub(&z0, &t0, &z0);
    fp2_dbl(&z0, &z0);
    fp2_add(&z0, &z0, &t0);
    fp2_add(&z1, &t1, &z1);
    fp2_dbl(&z1, &z1);
    fp2_add(&z1, &z1, &t1);
    fp4_sq(&t0, &t1, &z2, &z3);
    fp4_sq(&t2, &t3, &z4, &z5);
    fp2_sub(&z4, &t0, &z4);
    fp2_dbl(&z4, &z4);
    fp2_add(&z4, &z4, &t0);
    fp2_add(&z5, &t1, &z5);
    fp2_dbl(&z5, &z5);
    fp2_add(&z5, &z5, &t1);
    fp2_mul_by_nonres(&t0, &t3);
    fp2_add(&z2, &t0, &z2);
    fp2_dbl(&z2, &z2);
    fp2_add(&z2, &z2, &t0);
    fp2_sub(&z3, &t2, &z3);
    fp2_dbl(&z3, &z3);
    fp2_add(&z3, &z3, &t2);
    r->c0.c0 = z0;
    r->c0.c1 = z4;
    r->c0.c2 = z3;
    r->c1.c0 = z2;
    r->c1.c1 = z1;
    r->c1.c2 = z5;
}

static void cyclo_exp(fp12 *r, const fp12 *f) {
    /* f^|BLS_X|, then conjugate (x negative) */
    fp12 tmp;
    fp12_one(&tmp);
    int started = 0;
    for (int i = 63; i >= 0; i--) {
        if (started) cyclo_sq(&tmp, &tmp);
        if ((BLS_X >> i) & 1) {
            started = 1;
            fp12_mul(&tmp, &tmp, f);
        }
    }
    fp12_conj(r, &tmp);
}

static void final_exp(fp12 *r, const fp12 *f) {
    fp12 t0, t1, t2, t3, t4, t5, t6, tin;
    fp12_inv(&tin, f);
    fp12_conj(&t2, f);
    fp12_mul(&t2, &t2, &tin);
    t1 = t2;
    fp12_frob(&t2, &t2);
    fp12_frob(&t2, &t2);
    fp12_mul(&t2, &t2, &t1);
    cyclo_sq(&t1, &t2);
    fp12_conj(&t1, &t1);
    cyclo_exp(&t3, &t2);
    cyclo_sq(&t4, &t3);
    fp12_mul(&t5, &t1, &t3);
    cyclo_exp(&t1, &t5);
    cyclo_exp(&t0, &t1);
    cyclo_exp(&t6, &t0);
    fp12_mul(&t6, &t6, &t4);
    cyclo_exp(&t4, &t6);
    fp12_conj(&t5, &t5);
    fp12_mul(&t4, &t4, &t5);
    fp12_mul(&t4, &t4, &t2);
    fp12_conj(&t5, &t2);
    fp12_mul(&t1, &t1, &t2);
    fp12_frob(&t1, &t1);
    fp12_frob(&t1, &t1);
    fp12_frob(&t1, &t1);
    fp12_mul(&t6, &t6, &t5);
    fp12_frob(&t6, &t6);
    fp12_mul(&t3, &t3, &t0);
    fp12_frob(&t3, &t3);
    fp12_frob(&t3, &t3);
    fp12_mul(&t3, &t3, &t1);
    fp12_mul(&t3, &t3, &t6);
    fp12_mul(r, &t3, &t4);
}

/* ---------------- Miller loop ---------------- */

typedef struct { fp2 x, y, z; } g2_proj;

typedef struct { fp2 c0, c1, c2; } line_t;

/* doubling step on Jacobian-style G2 (fast_tower.prepare_g2 port) */
static void g2_doubling_step(g2_proj *r, line_t *l) {
    fp2 tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, zsq, nx, ny, nz, t8, t14;
    fp2_sqr(&tmp0, &r->x);
    fp2_sqr(&tmp1, &r->y);
    fp2_sqr(&tmp2, &tmp1);
    fp2_add(&tmp3, &tmp1, &r->x);
    fp2_sqr(&tmp3, &tmp3);
    fp2_sub(&tmp3, &tmp3, &tmp0);
    fp2_sub(&tmp3, &tmp3, &tmp2);
    fp2_dbl(&tmp3, &tmp3);
    fp2_add(&tmp4, &tmp0, &tmp0);
    fp2_add(&tmp4, &tmp4, &tmp0);
    fp2_add(&tmp6, &r->x, &tmp4);
    fp2_sqr(&tmp5, &tmp4);
    fp2_sqr(&zsq, &r->z);
    fp2_sub(&nx, &tmp5, &tmp3);
    fp2_sub(&nx, &nx, &tmp3);
    fp2_add(&nz, &r->z, &r->y);
    fp2_sqr(&nz, &nz);
    fp2_sub(&nz, &nz, &tmp1);
    fp2_sub(&nz, &nz, &zsq);
    fp2_sub(&ny, &tmp3, &nx);
    fp2_mul(&ny, &ny, &tmp4);
    fp2_dbl(&t8, &tmp2);
    fp2_dbl(&t8, &t8);
    fp2_dbl(&t8, &t8);
    fp2_sub(&ny, &ny, &t8);
    fp2_mul(&tmp3, &tmp4, &zsq);
    fp2_dbl(&tmp3, &tmp3);
    fp2_neg(&tmp3, &tmp3);
    fp2_sqr(&tmp6, &tmp6);
    fp2_sub(&tmp6, &tmp6, &tmp0);
    fp2_sub(&tmp6, &tmp6, &tmp5);
    fp2_dbl(&t14, &tmp1);
    fp2_dbl(&t14, &t14);
    fp2_sub(&tmp6, &tmp6, &t14);
    fp2_mul(&tmp0, &nz, &zsq);
    fp2_dbl(&tmp0, &tmp0);
    r->x = nx;
    r->y = ny;
    r->z = nz;
    l->c0 = tmp0;
    l->c1 = tmp3;
    l->c2 = tmp6;
}

static void g2_addition_step(g2_proj *r, const fp2 *qx, const fp2 *qy,
                             line_t *l) {
    fp2 zsq, ysq, t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, nx, ny, nz,
        ztsq;
    fp2_sqr(&zsq, &r->z);
    fp2_sqr(&ysq, qy);
    fp2_mul(&t0, &zsq, qx);
    fp2_add(&t1, qy, &r->z);
    fp2_sqr(&t1, &t1);
    fp2_sub(&t1, &t1, &ysq);
    fp2_sub(&t1, &t1, &zsq);
    fp2_mul(&t1, &t1, &zsq);
    fp2_sub(&t2, &t0, &r->x);
    fp2_sqr(&t3, &t2);
    fp2_dbl(&t4, &t3);
    fp2_dbl(&t4, &t4);
    fp2_mul(&t5, &t4, &t2);
    fp2_sub(&t6, &t1, &r->y);
    fp2_sub(&t6, &t6, &r->y);
    fp2_mul(&t9, &t6, qx);
    fp2_mul(&t7, &t4, &r->x);
    fp2_sqr(&nx, &t6);
    fp2_sub(&nx, &nx, &t5);
    fp2_sub(&nx, &nx, &t7);
    fp2_sub(&nx, &nx, &t7);
    fp2_add(&nz, &r->z, &t2);
    fp2_sqr(&nz, &nz);
    fp2_sub(&nz, &nz, &zsq);
    fp2_sub(&nz, &nz, &t3);
    fp2_add(&t10, qy, &nz);
    fp2_sub(&t8, &t7, &nx);
    fp2_mul(&t8, &t8, &t6);
    fp2_mul(&t0, &r->y, &t5);
    fp2_dbl(&t0, &t0);
    fp2_sub(&ny, &t8, &t0);
    fp2_sqr(&t10, &t10);
    fp2_sub(&t10, &t10, &ysq);
    fp2_sqr(&ztsq, &nz);
    fp2_sub(&t10, &t10, &ztsq);
    fp2_dbl(&t9, &t9);
    fp2_sub(&t9, &t9, &t10);
    fp2_dbl(&t10, &nz);
    fp2_neg(&t6, &t6);
    fp2_dbl(&t1, &t6);
    r->x = nx;
    r->y = ny;
    r->z = nz;
    l->c0 = t10;
    l->c1 = t1;
    l->c2 = t9;
}

/* 64 + popcount-ish upper bound on coefficient count */
#define MAX_COEFFS 70

static int g2_prepare(line_t *coeffs, const fp2 *qx, const fp2 *qy) {
    g2_proj r;
    r.x = *qx;
    r.y = *qy;
    memset(&r.z, 0, sizeof(r.z));
    r.z.c0 = FP_ONE;
    int n = 0;
    u64 x = BLS_X >> 1;
    int found_one = 0;
    for (int i = 63; i >= 0; i--) {
        int bit = (int)((x >> i) & 1);
        if (!found_one) {
            found_one = bit;
            continue;
        }
        g2_doubling_step(&r, &coeffs[n++]);
        if (bit) g2_addition_step(&r, qx, qy, &coeffs[n++]);
    }
    g2_doubling_step(&r, &coeffs[n++]);
    return n;
}

/* terms: n G1 affine (fp pairs, Montgomery) + n prepared coeff arrays */
static void miller_loop(fp12 *f, const fp *px, const fp *py,
                        line_t (*coeffs)[MAX_COEFFS], size_t n) {
    fp12_one(f);
    int cursor = 0;
    u64 x = BLS_X >> 1;
    int found_one = 0;
    for (int i = 63; i >= 0; i--) {
        int bit = (int)((x >> i) & 1);
        if (!found_one) {
            found_one = bit;
            continue;
        }
        for (size_t t = 0; t < n; t++) {
            line_t *c = &coeffs[t][cursor];
            fp2 c0, c1;
            fp2_mul_fp(&c0, &c->c0, &py[t]);
            fp2_mul_fp(&c1, &c->c1, &px[t]);
            fp12_mul_by_014(f, f, &c->c2, &c1, &c0);
        }
        cursor++;
        if (bit) {
            for (size_t t = 0; t < n; t++) {
                line_t *c = &coeffs[t][cursor];
                fp2 c0, c1;
                fp2_mul_fp(&c0, &c->c0, &py[t]);
                fp2_mul_fp(&c1, &c->c1, &px[t]);
                fp12_mul_by_014(f, f, &c->c2, &c1, &c0);
            }
            cursor++;
        }
        fp12_sqr(f, f);
    }
    for (size_t t = 0; t < n; t++) {
        line_t *c = &coeffs[t][cursor];
        fp2 c0, c1;
        fp2_mul_fp(&c0, &c->c0, &py[t]);
        fp2_mul_fp(&c1, &c->c1, &px[t]);
        fp12_mul_by_014(f, f, &c->c2, &c1, &c0);
    }
    fp12_conj(f, f); /* BLS_X negative */
}

/* ---------------- G1 Jacobian + Pippenger MSM ---------------- */

typedef struct { fp x, y; int inf; } g1_aff;
typedef struct { fp x, y, z; } g1_jac; /* z == 0 -> infinity */

static inline int g1_jac_is_inf(const g1_jac *p) { return fp_is_zero(&p->z); }

static void g1_dbl(g1_jac *r, const g1_jac *p) {
    /* dbl-2009-l (a = 0) */
    if (g1_jac_is_inf(p)) { *r = *p; return; }
    fp a, b, c, d, e, f2, t;
    fp_sqr(&a, &p->x);
    fp_sqr(&b, &p->y);
    fp_sqr(&c, &b);
    fp_add(&d, &p->x, &b);
    fp_sqr(&d, &d);
    fp_sub(&d, &d, &a);
    fp_sub(&d, &d, &c);
    fp_dbl(&d, &d);
    fp_dbl(&e, &a);
    fp_add(&e, &e, &a);
    fp_sqr(&f2, &e);
    fp_sub(&f2, &f2, &d);
    fp_sub(&f2, &f2, &d);
    fp_mul(&t, &p->y, &p->z);
    fp_dbl(&r->z, &t);
    fp_sub(&t, &d, &f2);
    fp_mul(&t, &t, &e);
    fp c8;
    fp_dbl(&c8, &c);
    fp_dbl(&c8, &c8);
    fp_dbl(&c8, &c8);
    fp_sub(&r->y, &t, &c8);
    r->x = f2;
}

static void g1_add(g1_jac *r, const g1_jac *p, const g1_jac *q) {
    if (g1_jac_is_inf(p)) { *r = *q; return; }
    if (g1_jac_is_inf(q)) { *r = *p; return; }
    /* add-2007-bl */
    fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t;
    fp_sqr(&z1z1, &p->z);
    fp_sqr(&z2z2, &q->z);
    fp_mul(&u1, &p->x, &z2z2);
    fp_mul(&u2, &q->x, &z1z1);
    fp_mul(&s1, &p->y, &q->z);
    fp_mul(&s1, &s1, &z2z2);
    fp_mul(&s2, &q->y, &p->z);
    fp_mul(&s2, &s2, &z1z1);
    fp_sub(&h, &u2, &u1);
    if (fp_is_zero(&h)) {
        fp d;
        fp_sub(&d, &s2, &s1);
        if (fp_is_zero(&d)) { g1_dbl(r, p); return; }
        memset(r, 0, sizeof(*r));
        return;
    }
    fp_dbl(&i, &h);
    fp_sqr(&i, &i);
    fp_mul(&j, &h, &i);
    fp_sub(&rr, &s2, &s1);
    fp_dbl(&rr, &rr);
    fp_mul(&v, &u1, &i);
    fp_sqr(&t, &rr);
    fp_sub(&t, &t, &j);
    fp_sub(&t, &t, &v);
    fp_sub(&t, &t, &v);
    r->x = t;
    fp_sub(&t, &v, &r->x);
    fp_mul(&t, &t, &rr);
    fp_mul(&s1, &s1, &j);
    fp_dbl(&s1, &s1);
    fp_sub(&r->y, &t, &s1);
    fp_add(&t, &p->z, &q->z);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &z1z1);
    fp_sub(&t, &t, &z2z2);
    fp_mul(&r->z, &t, &h);
}

static void g1_add_mixed(g1_jac *r, const g1_jac *p, const g1_aff *q) {
    if (q->inf) { *r = *p; return; }
    if (g1_jac_is_inf(p)) {
        r->x = q->x;
        r->y = q->y;
        memset(&r->z, 0, sizeof(r->z));
        r->z = FP_ONE;
        return;
    }
    /* madd-2007-bl */
    fp z1z1, u2, s2, h, hh, i, j, rr, v, t;
    fp_sqr(&z1z1, &p->z);
    fp_mul(&u2, &q->x, &z1z1);
    fp_mul(&s2, &q->y, &p->z);
    fp_mul(&s2, &s2, &z1z1);
    fp_sub(&h, &u2, &p->x);
    if (fp_is_zero(&h)) {
        fp d;
        fp_sub(&d, &s2, &p->y);
        if (fp_is_zero(&d)) { g1_dbl(r, p); return; }
        memset(r, 0, sizeof(*r));
        return;
    }
    fp_sqr(&hh, &h);
    fp_dbl(&i, &hh);
    fp_dbl(&i, &i);
    fp_mul(&j, &h, &i);
    fp_sub(&rr, &s2, &p->y);
    fp_dbl(&rr, &rr);
    fp_mul(&v, &p->x, &i);
    fp_sqr(&t, &rr);
    fp_sub(&t, &t, &j);
    fp_sub(&t, &t, &v);
    fp_sub(&t, &t, &v);
    r->x = t;
    fp_sub(&t, &v, &r->x);
    fp_mul(&t, &t, &rr);
    fp_mul(&j, &j, &p->y);
    fp_dbl(&j, &j);
    fp_sub(&r->y, &t, &j);
    fp_add(&t, &p->z, &h);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &z1z1);
    fp_sub(&t, &t, &hh);
    r->z = t;
}

static void g1_to_affine_bytes(uint8_t *out97, const g1_jac *p) {
    if (g1_jac_is_inf(p)) {
        memset(out97, 0, 97);
        out97[96] = 1;
        return;
    }
    fp zi, zi2, zi3, ax, ay;
    fp_inv(&zi, &p->z);
    fp_sqr(&zi2, &zi);
    fp_mul(&zi3, &zi2, &zi);
    fp_mul(&ax, &p->x, &zi2);
    fp_mul(&ay, &p->y, &zi3);
    fp_to_bytes(out97, &ax);
    fp_to_bytes(out97 + 48, &ay);
    out97[96] = 0;
}

/* Straus joint-scalar MSM with wNAF-4 digits -- beats Pippenger below a
 * few hundred points (the verifier's linearization MSM shape): one shared
 * doubling chain, per-point odd-multiple tables. */
static void msm_straus(g1_jac *out, const g1_aff *pts,
                       const uint8_t *scalars, size_t n) {
    /* wNAF-4: digits in {0, +-1, +-3, ..., +-15}, table = 8 odd multiples */
    enum { W = 4, TBL = 8, NDIG = 257 };
    int8_t *naf = (int8_t *)malloc(n * NDIG);
    g1_jac *tbl = (g1_jac *)malloc(n * TBL * sizeof(g1_jac));
    for (size_t i = 0; i < n; i++) {
        /* recode scalar i */
        u64 s[5] = {0, 0, 0, 0, 0};
        memcpy(s, scalars + 32 * i, 32);
        int8_t *d = naf + NDIG * i;
        memset(d, 0, NDIG);
        int pos = 0;
        while (s[0] | s[1] | s[2] | s[3] | s[4]) {
            if (s[0] & 1) {
                int v = (int)(s[0] & ((1u << (W + 1)) - 1)); /* 5 bits */
                if (v > (1 << W)) v -= 1 << (W + 1);
                d[pos] = (int8_t)v;
                /* subtract v (signed) from s */
                if (v > 0) {
                    u128 bor = 0;
                    u64 vv = (u64)v;
                    for (int k = 0; k < 5; k++) {
                        u128 dd = (u128)s[k] - (k ? 0 : vv) - bor;
                        s[k] = (u64)dd;
                        bor = (dd >> 64) & 1;
                    }
                } else {
                    u128 car = (u64)(-v);
                    for (int k = 0; k < 5 && car; k++) {
                        car += s[k];
                        s[k] = (u64)car;
                        car >>= 64;
                    }
                }
            }
            /* shift right 1 */
            for (int k = 0; k < 4; k++)
                s[k] = (s[k] >> 1) | (s[k + 1] << 63);
            s[4] >>= 1;
            pos++;
        }
        /* table: p, 3p, 5p, ..., 15p */
        g1_jac *t = tbl + TBL * i;
        if (pts[i].inf) {
            memset(t, 0, TBL * sizeof(g1_jac));
            memset(d, 0, NDIG);
            continue;
        }
        t[0].x = pts[i].x;
        t[0].y = pts[i].y;
        t[0].z = FP_ONE;
        g1_jac twop;
        g1_dbl(&twop, &t[0]);
        for (int k = 1; k < TBL; k++) g1_add(&t[k], &t[k - 1], &twop);
    }
    g1_jac acc;
    memset(&acc, 0, sizeof(acc));
    for (int pos = NDIG - 1; pos >= 0; pos--) {
        g1_dbl(&acc, &acc);
        for (size_t i = 0; i < n; i++) {
            int v = naf[NDIG * i + pos];
            if (!v) continue;
            g1_jac t = tbl[TBL * i + (abs(v) >> 1)];
            if (v < 0) fp_neg(&t.y, &t.y);
            g1_add(&acc, &acc, &t);
        }
    }
    *out = acc;
    free(tbl);
    free(naf);
}

/* ---------------- public ABI ---------------- */

#define EXPORT __attribute__((visibility("default")))

/* points: n*96 LE affine coords (x=y=0 => infinity); scalars: n*32 LE;
 * out: 97 bytes affine (+ infinity flag). */
EXPORT void bls_msm(const uint8_t *points, const uint8_t *scalars,
                    size_t n, uint8_t *out97) {
    g1_aff *pts = (g1_aff *)malloc(n * sizeof(g1_aff));
    for (size_t i = 0; i < n; i++) {
        const uint8_t *c = points + 96 * i;
        int zero = 1;
        for (int j = 0; j < 96; j++) zero &= c[j] == 0;
        pts[i].inf = zero;
        if (!zero) {
            fp_from_bytes(&pts[i].x, c);
            fp_from_bytes(&pts[i].y, c + 48);
        }
    }
    if (n <= 256) {
        g1_jac total;
        msm_straus(&total, pts, scalars, n);
        g1_to_affine_bytes(out97, &total);
        free(pts);
        return;
    }
    int c = 7;
    if (n >= 4096) c = 11;
    if (n >= 262144) c = 15;
    int windows = (256 + c - 1) / c;
    size_t nbuckets = ((size_t)1 << c) - 1;
    g1_jac *wsums = (g1_jac *)calloc((size_t)windows, sizeof(g1_jac));

#pragma omp parallel
    {
        g1_jac *buckets = (g1_jac *)malloc(nbuckets * sizeof(g1_jac));
#pragma omp for schedule(dynamic, 1)
        for (int w = 0; w < windows; w++) {
            memset(buckets, 0, nbuckets * sizeof(g1_jac));
            int bitpos = w * c;
            for (size_t i = 0; i < n; i++) {
                if (pts[i].inf) continue;
                const uint8_t *s = scalars + 32 * i;
                /* extract c bits at bitpos from the 256-bit LE scalar */
                u64 acc = 0;
                for (int b = 0; b < c; b++) {
                    int pos = bitpos + b;
                    if (pos >= 256) break;
                    acc |= (u64)((s[pos >> 3] >> (pos & 7)) & 1) << b;
                }
                if (acc == 0) continue;
                g1_add_mixed(&buckets[acc - 1], &buckets[acc - 1], &pts[i]);
            }
            g1_jac sum, running;
            memset(&sum, 0, sizeof(sum));
            memset(&running, 0, sizeof(running));
            for (size_t b = nbuckets; b > 0; b--) {
                g1_add(&running, &running, &buckets[b - 1]);
                g1_add(&sum, &sum, &running);
            }
            wsums[w] = sum;
        }
        free(buckets);
    }

    g1_jac total;
    memset(&total, 0, sizeof(total));
    for (int w = windows - 1; w >= 0; w--) {
        for (int b = 0; b < c && w != windows - 1; b++) g1_dbl(&total, &total);
        g1_add(&total, &total, &wsums[w]);
    }
    /* top window needs no pre-doubling; loop above doubles before adding
     * each lower window */
    g1_to_affine_bytes(out97, &total);
    free(wsums);
    free(pts);
}

/* g1s: n*96 LE affine, g2s: n*192 LE affine (x.c0,x.c1,y.c0,y.c1);
 * out: 576-byte fp12 (canonical LE tower order). Identity terms must be
 * filtered by the caller. */
EXPORT void bls_miller_loop(const uint8_t *g1s, const uint8_t *g2s,
                            size_t n, uint8_t *out576) {
    fp *px = (fp *)malloc(n * sizeof(fp));
    fp *py = (fp *)malloc(n * sizeof(fp));
    line_t(*coeffs)[MAX_COEFFS] =
        (line_t(*)[MAX_COEFFS])malloc(n * sizeof(*coeffs));
    for (size_t i = 0; i < n; i++) {
        fp_from_bytes(&px[i], g1s + 96 * i);
        fp_from_bytes(&py[i], g1s + 96 * i + 48);
        fp2 qx, qy;
        fp_from_bytes(&qx.c0, g2s + 192 * i);
        fp_from_bytes(&qx.c1, g2s + 192 * i + 48);
        fp_from_bytes(&qy.c0, g2s + 192 * i + 96);
        fp_from_bytes(&qy.c1, g2s + 192 * i + 144);
        g2_prepare(coeffs[i], &qx, &qy);
    }
    fp12 f;
    miller_loop(&f, px, py, coeffs, n);
    const fp *src = (const fp *)&f;
    for (int i = 0; i < 12; i++) fp_to_bytes(out576 + 48 * i, &src[i]);
    free(coeffs);
    free(py);
    free(px);
}

EXPORT void bls_final_exp(const uint8_t *in576, uint8_t *out576) {
    fp12 f, r;
    fp *dst = (fp *)&f;
    for (int i = 0; i < 12; i++) fp_from_bytes(&dst[i], in576 + 48 * i);
    final_exp(&r, &f);
    const fp *src = (const fp *)&r;
    for (int i = 0; i < 12; i++) fp_to_bytes(out576 + 48 * i, &src[i]);
}

/* ---------------- Keccak-f[1600] (transcript permutation) ----------------
 * The STROBE-128 transcript calls this ~20x per verify; the permutation is
 * pure bit-twiddling, so the Python fallback (plonk/transcript.py) costs
 * more than the two pairings did once everything else is native. */

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int KECCAK_ROT[5][5] = {{0, 36, 3, 41, 18},
                                     {1, 44, 10, 45, 2},
                                     {62, 6, 43, 15, 61},
                                     {28, 55, 25, 21, 56},
                                     {27, 20, 39, 8, 14}};

static inline u64 rotl64(u64 v, int n) {
    return n ? (v << n) | (v >> (64 - n)) : v;
}

EXPORT void keccak_f1600(uint8_t *state) {
    u64 a[5][5];
    for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
            memcpy(&a[x][y], state + 8 * (x + 5 * y), 8);
    for (int r = 0; r < 24; r++) {
        u64 c[5], d[5], b[5][5];
        for (int x = 0; x < 5; x++)
            c[x] = a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y][(2 * x + 3 * y) % 5] = rotl64(a[x][y] ^ d[x],
                                                   KECCAK_ROT[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x][y] = b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y]);
        a[0][0] ^= KECCAK_RC[r];
    }
    for (int x = 0; x < 5; x++)
        for (int y = 0; y < 5; y++)
            memcpy(state + 8 * (x + 5 * y), &a[x][y], 8);
}

/* full check: final_exp(prod miller) == 1.  Returns 1 on success. */
EXPORT int bls_pairing_check(const uint8_t *g1s, const uint8_t *g2s,
                             size_t n) {
    uint8_t mil[576];
    bls_miller_loop(g1s, g2s, n, mil);
    fp12 f, r;
    fp *dst = (fp *)&f;
    for (int i = 0; i < 12; i++) fp_from_bytes(&dst[i], mil + 48 * i);
    final_exp(&r, &f);
    return fp12_is_one(&r);
}
