"""Procedural raw-int Fp-tower pairing kernels (verify hot path).

The class-based tower (fields/fp{2,6,12}.py) spends ~3.5us per Fp multiply
on Python object dispatch; a verify was ~0.15s of that.  This module runs
the same formulas on plain int tuples (fp2 = (c0, c1), fp6 = 3 fp2,
fp12 = 2 fp6) with lazy signed accumulation -- Python's % normalizes at
each multiply -- and is the engine behind `curves.pairing.multi_miller_loop`
/ `final_exponentiation`.  Values are exact canonical integers, so results
are identical to the class tower (pinned by tests/test_curves.py,
tests/test_golden_vectors.py relic vectors, and a direct cross-test).

Reference semantics: coset-bls12_381/src/pairings.rs:43-628 (Miller loop,
G2Prepared line coefficients, cyclotomic final exponentiation).
"""

from __future__ import annotations

from .. import params

P = params.FP_MODULUS

# -----------------------------------------------------------------------------
# fp2 = (c0, c1) mod p; u^2 = -1.  Inputs may be non-canonical (lazy sums);
# multiplies renormalize via %.
# -----------------------------------------------------------------------------


def mul2(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def sq2(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def add2(a, b):
    return (a[0] + b[0], a[1] + b[1])


def sub2(a, b):
    return (a[0] - b[0], a[1] - b[1])


def neg2(a):
    return (-a[0], -a[1])


def mbnr2(a):
    """* (u + 1)."""
    return (a[0] - a[1], a[0] + a[1])


def conj2(a):
    return (a[0] % P, -a[1] % P)


def norm2(a):
    return (a[0] % P, a[1] % P)


def inv2(a):
    a0, a1 = a[0] % P, a[1] % P
    norm = (a0 * a0 + a1 * a1) % P
    inv = pow(norm, -1, P)
    return (a0 * inv % P, -a1 * inv % P)


_ZERO2 = (0, 0)
_ONE2 = (1, 0)

# -----------------------------------------------------------------------------
# fp6 = (c0, c1, c2) of fp2; v^3 = u + 1
# -----------------------------------------------------------------------------


def mul6(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = mul2(a0, b0)
    t1 = mul2(a1, b1)
    t2 = mul2(a2, b2)
    c0 = add2(mbnr2(sub2(sub2(mul2(add2(a1, a2), add2(b1, b2)), t1), t2)), t0)
    c1 = add2(sub2(sub2(mul2(add2(a0, a1), add2(b0, b1)), t0), t1), mbnr2(t2))
    c2 = add2(sub2(sub2(mul2(add2(a0, a2), add2(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def mul6_by_01(a, b0, b1):
    a0, a1, a2 = a
    t0 = mul2(a0, b0)
    t1 = mul2(a1, b1)
    c0 = add2(mbnr2(sub2(mul2(add2(a1, a2), b1), t1)), t0)
    c1 = sub2(sub2(mul2(add2(b0, b1), add2(a0, a1)), t0), t1)
    c2 = add2(mul2(a2, b0), t1)
    return (c0, c1, c2)


def mul6_by_1(a, b1):
    a0, a1, a2 = a
    return (mbnr2(sub2(mul2(add2(a1, a2), b1), mul2(a1, b1))),
            mul2(a0, b1), mul2(a1, b1))


def mbnr6(a):
    return (mbnr2(a[2]), a[0], a[1])


def add6(a, b):
    return tuple(add2(x, y) for x, y in zip(a, b))


def sub6(a, b):
    return tuple(sub2(x, y) for x, y in zip(a, b))


def neg6(a):
    return tuple(neg2(x) for x in a)


def inv6(a):
    a0, a1, a2 = a
    c0 = sub2(sq2(a0), mbnr2(mul2(a1, a2)))
    c1 = sub2(mbnr2(sq2(a2)), mul2(a0, a1))
    c2 = sub2(sq2(a1), mul2(a0, a2))
    t = inv2(add2(mbnr2(add2(mul2(a2, c1), mul2(a1, c2))), mul2(a0, c0)))
    return (mul2(c0, t), mul2(c1, t), mul2(c2, t))


_ZERO6 = (_ZERO2, _ZERO2, _ZERO2)
_ONE6 = (_ONE2, _ZERO2, _ZERO2)

# Frobenius coefficients (fp6.rs / fp12.rs)


def _fp2_pow(base, e):
    r = _ONE2
    b = base
    while e > 0:
        if e & 1:
            r = mul2(r, b)
        b = sq2(b)
        e >>= 1
    return r


_FROB6_C1 = _fp2_pow((1, 1), (P - 1) // 3)
_FROB6_C2 = _fp2_pow((1, 1), (2 * P - 2) // 3)
_FROB12_C1 = _fp2_pow((1, 1), (P - 1) // 6)


def frob6(a):
    return (conj2(a[0]), mul2(conj2(a[1]), _FROB6_C1),
            mul2(conj2(a[2]), _FROB6_C2))


# -----------------------------------------------------------------------------
# fp12 = (c0, c1) of fp6; w^2 = v
# -----------------------------------------------------------------------------


def mul12(a, b):
    aa = mul6(a[0], b[0])
    bb = mul6(a[1], b[1])
    c1 = sub6(sub6(mul6(add6(a[1], a[0]), add6(b[0], b[1])), aa), bb)
    c0 = add6(mbnr6(bb), aa)
    return (c0, c1)


def sq12(a):
    ab = mul6(a[0], a[1])
    c0 = sub6(sub6(mul6(add6(mbnr6(a[1]), a[0]), add6(a[0], a[1])), ab),
              mbnr6(ab))
    return (c0, add6(ab, ab))


def mul12_by_014(f, c0, c1, c4):
    aa = mul6_by_01(f[0], c0, c1)
    bb = mul6_by_1(f[1], c4)
    o = add2(c1, c4)
    nc1 = sub6(sub6(mul6_by_01(add6(f[1], f[0]), c0, o), aa), bb)
    nc0 = add6(mbnr6(bb), aa)
    return (nc0, nc1)


def conj12(a):
    return (a[0], neg6(a[1]))


def frob12(a):
    c0 = frob6(a[0])
    c1 = frob6(a[1])
    return (c0, tuple(mul2(x, _FROB12_C1) for x in c1))


def inv12(a):
    t = inv6(sub6(mul6(a[0], a[0]), mbnr6(mul6(a[1], a[1]))))
    return (mul6(a[0], t), neg6(mul6(a[1], t)))


ONE12 = (_ONE6, _ZERO6)


def norm12(a):
    return tuple(tuple(norm2(x) for x in c) for c in a)


# -----------------------------------------------------------------------------
# Miller loop over prepared raw line coefficients
# -----------------------------------------------------------------------------


def prepare_g2(qx, qy):
    """Line coefficients for every Miller step from affine (qx, qy) fp2
    coords -- the G2Prepared construction (pairings.rs:62-177) on raw ints.
    Returns a list of (c0, c1, c2) fp2 triples."""
    rx, ry, rz = qx, qy, _ONE2
    coeffs = []

    def doubling_step():
        nonlocal rx, ry, rz
        tmp0 = sq2(rx)
        tmp1 = sq2(ry)
        tmp2 = sq2(tmp1)
        tmp3 = sub2(sub2(sq2(add2(tmp1, rx)), tmp0), tmp2)
        tmp3 = add2(tmp3, tmp3)
        tmp4 = add2(add2(tmp0, tmp0), tmp0)
        tmp6 = add2(rx, tmp4)
        tmp5 = sq2(tmp4)
        zsq = sq2(rz)
        nx = sub2(sub2(tmp5, tmp3), tmp3)
        nz = sub2(sub2(sq2(add2(rz, ry)), tmp1), zsq)
        ny = mul2(sub2(tmp3, nx), tmp4)
        t8 = add2(tmp2, tmp2)
        t8 = add2(t8, t8)
        t8 = add2(t8, t8)
        ny = sub2(ny, t8)
        tmp3 = mul2(tmp4, zsq)
        tmp3 = add2(tmp3, tmp3)
        tmp3 = neg2(tmp3)
        tmp6 = sub2(sub2(sq2(tmp6), tmp0), tmp5)
        t14 = add2(tmp1, tmp1)
        t14 = add2(t14, t14)
        tmp6 = sub2(tmp6, t14)
        tmp0 = mul2(nz, zsq)
        tmp0 = add2(tmp0, tmp0)
        rx, ry, rz = nx, ny, nz
        return (norm2(tmp0), norm2(tmp3), norm2(tmp6))

    def addition_step():
        nonlocal rx, ry, rz
        zsq = sq2(rz)
        ysq = sq2(qy)
        t0 = mul2(zsq, qx)
        t1 = mul2(sub2(sub2(sq2(add2(qy, rz)), ysq), zsq), zsq)
        t2 = sub2(t0, rx)
        t3 = sq2(t2)
        t4 = add2(t3, t3)
        t4 = add2(t4, t4)
        t5 = mul2(t4, t2)
        t6 = sub2(sub2(t1, ry), ry)
        t9 = mul2(t6, qx)
        t7 = mul2(t4, rx)
        nx = sub2(sub2(sub2(sq2(t6), t5), t7), t7)
        nz = sub2(sub2(sq2(add2(rz, t2)), zsq), t3)
        t10 = add2(qy, nz)
        t8 = mul2(sub2(t7, nx), t6)
        t0 = mul2(ry, t5)
        t0 = add2(t0, t0)
        ny = sub2(t8, t0)
        t10 = sub2(sq2(t10), ysq)
        ztsq = sq2(nz)
        t10 = sub2(t10, ztsq)
        t9 = sub2(add2(t9, t9), t10)
        t10 = add2(nz, nz)
        t6 = neg2(t6)
        t1 = add2(t6, t6)
        rx, ry, rz = nx, ny, nz
        return (norm2(t10), norm2(t1), norm2(t9))

    x = params.BLS_X >> 1
    found_one = False
    for i in range(63, -1, -1):
        bit = (x >> i) & 1
        if not found_one:
            found_one = bit == 1
            continue
        coeffs.append(doubling_step())
        if bit:
            coeffs.append(addition_step())
    coeffs.append(doubling_step())
    return coeffs


def miller_loop(terms):
    """terms: [(px, py, coeffs)] with px/py canonical G1 ints and coeffs
    from prepare_g2.  Returns fp12 (pairings.rs multi_miller_loop)."""
    f = ONE12
    cursor = 0
    x = params.BLS_X >> 1

    def ell(f, coeffs, px, py):
        c0, c1, c2 = coeffs
        c0 = (c0[0] * py % P, c0[1] * py % P)
        c1 = (c1[0] * px % P, c1[1] * px % P)
        return mul12_by_014(f, c2, c1, c0)

    found_one = False
    for i in range(63, -1, -1):
        bit = (x >> i) & 1
        if not found_one:
            found_one = bit == 1
            continue
        for px, py, coeffs in terms:
            f = ell(f, coeffs[cursor], px, py)
        cursor += 1
        if bit:
            for px, py, coeffs in terms:
                f = ell(f, coeffs[cursor], px, py)
            cursor += 1
        f = sq12(f)
    for px, py, coeffs in terms:
        f = ell(f, coeffs[cursor], px, py)
    if params.BLS_X_IS_NEGATIVE:
        f = conj12(f)
    return f


# -----------------------------------------------------------------------------
# Final exponentiation (cyclotomic addition chain, pairings.rs:568-627)
# -----------------------------------------------------------------------------


def _fp4_sq(a, b):
    t0 = sq2(a)
    t1 = sq2(b)
    t2 = mbnr2(t1)
    c0 = add2(t2, t0)
    t2 = sub2(sub2(sq2(add2(a, b)), t0), t1)
    return c0, t2


def cyclo_sq(f):
    (z0, z4, z3), (z2, z1, z5) = f
    t0, t1 = _fp4_sq(z0, z1)
    z0 = sub2(t0, z0)
    z0 = add2(add2(z0, z0), t0)
    z1 = add2(t1, z1)
    z1 = add2(add2(z1, z1), t1)
    t0, t1 = _fp4_sq(z2, z3)
    t2, t3 = _fp4_sq(z4, z5)
    z4 = sub2(t0, z4)
    z4 = add2(add2(z4, z4), t0)
    z5 = add2(t1, z5)
    z5 = add2(add2(z5, z5), t1)
    t0 = mbnr2(t3)
    z2 = add2(t0, z2)
    z2 = add2(add2(z2, z2), t0)
    z3 = sub2(t2, z3)
    z3 = add2(add2(z3, z3), t2)
    return ((z0, z4, z3), (z2, z1, z5))


def cyclo_exp(f):
    """f^|BLS_X| (conjugated: BLS_X negative)."""
    x = params.BLS_X
    tmp = ONE12
    found_one = False
    for i in range(63, -1, -1):
        if found_one:
            tmp = cyclo_sq(tmp)
        if (x >> i) & 1:
            found_one = True
            tmp = mul12(tmp, f)
    return conj12(tmp) if params.BLS_X_IS_NEGATIVE else tmp


def final_exp(f):
    """f^(3*(p^4-p^2+1)/r), canonical output (the Granger-Scott chain)."""
    t2 = mul12(conj12(f), inv12(f))
    t1 = t2
    t2 = mul12(frob12(frob12(t2)), t1)
    t1 = conj12(cyclo_sq(t2))
    t3 = cyclo_exp(t2)
    t4 = cyclo_sq(t3)
    t5 = mul12(t1, t3)
    t1 = cyclo_exp(t5)
    t0 = cyclo_exp(t1)
    t6 = mul12(cyclo_exp(t0), t4)
    t4 = cyclo_exp(t6)
    t5 = conj12(t5)
    t4 = mul12(mul12(t4, t5), t2)
    t5 = conj12(t2)
    t1 = frob12(frob12(frob12(mul12(t1, t2))))
    t6 = frob12(mul12(t6, t5))
    t3 = frob12(frob12(mul12(t3, t0)))
    t3 = mul12(mul12(t3, t1), t6)
    return norm12(mul12(t3, t4))
