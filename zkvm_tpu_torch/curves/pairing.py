"""Optimal ate pairing on BLS12-381 (host; runs once per proof verification).

Miller loop with precomputed G2 line coefficients (the reference's
G2Prepared / multi_miller_loop structure, coset-bls12_381/src/pairings.rs:43-628).
The hard part of the final exponentiation is a plain exponentiation by
(p^4 - p^2 + 1)/r -- off the proving hot path, clarity over cycles.
Correctness is pinned by bilinearity/non-degeneracy tests (tests/test_curves.py).
"""

from __future__ import annotations

from .. import params
from ..fields import Fp, Fp2, Fp6, Fp12, Fr
from . import fast_tower
from .g1 import G1Affine
from .g2 import G2Affine, G2Projective

_P = Fp.MODULUS


class Gt:
    """Target group: the r-torsion of Fp12* (pairings.rs:628 Gt)."""

    __slots__ = ("value",)

    def __init__(self, value: Fp12):
        self.value = value

    @classmethod
    def identity(cls):
        return cls(Fp12.one())

    def __add__(self, other):
        return Gt(self.value * other.value)

    def __neg__(self):
        return Gt(self.value.conjugate())  # inverse in the cyclotomic subgroup

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, scalar):
        k = scalar.value if isinstance(scalar, Fr) else int(scalar) % Fr.MODULUS
        return Gt(self.value.pow(k))

    __rmul__ = __mul__

    def __eq__(self, other):
        return isinstance(other, Gt) and self.value == other.value

    def is_identity(self) -> bool:
        return self.value.is_one()


def _doubling_step(r: G2Projective):
    """One Miller doubling step; mutates r, returns line coeffs (c0, c1, c2)."""
    tmp0 = r.x.square()
    tmp1 = r.y.square()
    tmp2 = tmp1.square()
    tmp3 = (tmp1 + r.x).square() - tmp0 - tmp2
    tmp3 = tmp3 + tmp3
    tmp4 = tmp0 + tmp0 + tmp0
    tmp6 = r.x + tmp4
    tmp5 = tmp4.square()
    zsquared = r.z.square()
    r.x = tmp5 - tmp3 - tmp3
    r.z = (r.z + r.y).square() - tmp1 - zsquared
    r.y = (tmp3 - r.x) * tmp4
    tmp2_8 = tmp2 + tmp2
    tmp2_8 = tmp2_8 + tmp2_8
    tmp2_8 = tmp2_8 + tmp2_8
    r.y = r.y - tmp2_8
    tmp3 = tmp4 * zsquared
    tmp3 = tmp3 + tmp3
    tmp3 = -tmp3
    tmp6 = tmp6.square() - tmp0 - tmp5
    tmp1_4 = tmp1 + tmp1
    tmp1_4 = tmp1_4 + tmp1_4
    tmp6 = tmp6 - tmp1_4
    tmp0 = r.z * zsquared
    tmp0 = tmp0 + tmp0
    return (tmp0, tmp3, tmp6)


def _addition_step(r: G2Projective, q: G2Affine):
    """One Miller addition step with affine q; mutates r, returns line coeffs."""
    zsquared = r.z.square()
    ysquared = q.y.square()
    t0 = zsquared * q.x
    t1 = ((q.y + r.z).square() - ysquared - zsquared) * zsquared
    t2 = t0 - r.x
    t3 = t2.square()
    t4 = t3 + t3
    t4 = t4 + t4
    t5 = t4 * t2
    t6 = t1 - r.y - r.y
    t9 = t6 * q.x
    t7 = t4 * r.x
    r.x = t6.square() - t5 - t7 - t7
    r.z = (r.z + t2).square() - zsquared - t3
    t10 = q.y + r.z
    t8 = (t7 - r.x) * t6
    t0 = r.y * t5
    t0 = t0 + t0
    r.y = t8 - t0
    t10 = t10.square() - ysquared
    ztsquared = r.z.square()
    t10 = t10 - ztsquared
    t9 = t9 + t9 - t10
    t10 = r.z + r.z
    t6 = -t6
    t1 = t6 + t6
    return (t10, t1, t9)


class G2Prepared:
    """Precomputed line coefficients for every Miller-loop step
    (pairings.rs:62).  Built on the raw-int fast path (fast_tower);
    `.coeffs` materializes Fp2 objects lazily for the reference-class
    Miller loop used in cross-tests."""

    def __init__(self, q: G2Affine):
        self.infinity = q.is_identity()
        self.raw_coeffs: list = []
        self._coeffs_obj = None
        if self.infinity:
            return
        self.raw_coeffs = fast_tower.prepare_g2(
            (q.x.c0.value, q.x.c1.value), (q.y.c0.value, q.y.c1.value))

    @property
    def coeffs(self) -> list:
        if self._coeffs_obj is None:
            self._coeffs_obj = [
                tuple(Fp2(Fp(a), Fp(b)) for a, b in step)
                for step in self.raw_coeffs]
        return self._coeffs_obj


def _ell(f: Fp12, coeffs, p: G1Affine) -> Fp12:
    c0, c1, c2 = coeffs
    c0 = Fp2(c0.c0 * p.y, c0.c1 * p.y)
    c1 = Fp2(c1.c0 * p.x, c1.c1 * p.x)
    return f.mul_by_014(c2, c1, c0)


def multi_miller_loop(terms: list[tuple[G1Affine, G2Prepared]]) -> Fp12:
    """Product of Miller loops; skips identity terms (pairings.rs:510).
    Runs on the raw-int fast tower; `multi_miller_loop_ref` below is the
    class-based original, kept as the cross-check oracle."""
    live = [(p.x.value, p.y.value, q.raw_coeffs) for p, q in terms
            if not (p.is_identity() or q.infinity)]
    return _fp12_from_tuple(fast_tower.miller_loop(live))


def _fp12_to_tuple(f: Fp12):
    return tuple(
        tuple((c.c0.value, c.c1.value) for c in (six.c0, six.c1, six.c2))
        for six in (f.c0, f.c1))


def _fp12_from_tuple(t) -> Fp12:
    return Fp12(*(Fp6(*(Fp2(Fp(a % fast_tower.P), Fp(b % fast_tower.P))
                        for a, b in six)) for six in t))


def multi_miller_loop_ref(terms: list[tuple[G1Affine, G2Prepared]]) -> Fp12:
    """Class-tower Miller loop (bit-identical oracle for the fast path)."""
    live = [(p, q) for p, q in terms if not (p.is_identity() or q.infinity)]
    f = Fp12.one()
    cursor = 0
    x = params.BLS_X >> 1
    found_one = False
    for i in range(63, -1, -1):
        bit = (x >> i) & 1
        if not found_one:
            found_one = bit == 1
            continue
        for p, q in live:
            f = _ell(f, q.coeffs[cursor], p)
        cursor += 1
        if bit:
            for p, q in live:
                f = _ell(f, q.coeffs[cursor], p)
            cursor += 1
        f = f.square()
    for p, q in live:
        f = _ell(f, q.coeffs[cursor], p)
    if params.BLS_X_IS_NEGATIVE:
        f = f.conjugate()
    return f


_HARD_EXP = 3 * ((_P**4 - _P**2 + 1) // Fr.MODULUS)


def _fp4_square(a: Fp2, b: Fp2) -> tuple[Fp2, Fp2]:
    """(a + b*v)^2 in Fp4 = Fp2[v]/(v^2 - u) (pairings.rs fp4_square)."""
    t0 = a.square()
    t1 = b.square()
    t2 = t1.mul_by_nonresidue()
    c0 = t2 + t0
    t2 = (a + b).square() - t0 - t1
    return c0, t2


def cyclotomic_square(f: Fp12) -> Fp12:
    """Granger-Scott squaring for cyclotomic-subgroup elements
    (pairings.rs cyclotomic_square): 3 Fp4 squarings instead of a full
    Fp12 square -- the workhorse of the hard-part addition chain."""
    z0, z4, z3 = f.c0.c0, f.c0.c1, f.c0.c2
    z2, z1, z5 = f.c1.c0, f.c1.c1, f.c1.c2

    t0, t1 = _fp4_square(z0, z1)
    z0 = t0 - z0
    z0 = z0 + z0 + t0
    z1 = t1 + z1
    z1 = z1 + z1 + t1

    t0, t1 = _fp4_square(z2, z3)
    t2, t3 = _fp4_square(z4, z5)

    z4 = t0 - z4
    z4 = z4 + z4 + t0
    z5 = t1 + z5
    z5 = z5 + z5 + t1

    t0 = t3.mul_by_nonresidue()
    z2 = t0 + z2
    z2 = z2 + z2 + t0
    z3 = t2 - z3
    z3 = z3 + z3 + t2

    return Fp12(Fp6(z0, z4, z3), Fp6(z2, z1, z5))


def _cyclotomic_exp(f: Fp12) -> Fp12:
    """f^|BLS_X| by square-and-multiply with cyclotomic squarings, then
    conjugate (BLS_X is negative) -- pairings.rs cycolotomic_exp."""
    x = params.BLS_X
    tmp = Fp12.one()
    found_one = False
    for i in range(63, -1, -1):
        if found_one:
            tmp = cyclotomic_square(tmp)
        bit = (x >> i) & 1
        if bit:
            found_one = True
            tmp = tmp * f
    return tmp.conjugate() if params.BLS_X_IS_NEGATIVE else tmp


def final_exponentiation(f: Fp12) -> Gt:
    """Fast-path final exponentiation (raw-int cyclotomic chain)."""
    return Gt(_fp12_from_tuple(fast_tower.final_exp(_fp12_to_tuple(f))))


def final_exponentiation_ref(f: Fp12) -> Gt:
    """Easy part by frobenius/inversion; hard part by the reference's
    addition chain (pairings.rs final_exponentiation / the zkcrypto chain),
    which computes f^(3*(p^4 - p^2 + 1)/r) -- the cube of the minimal
    pairing, still perfect since gcd(3, r) = 1.  Gt values stay
    bit-identical to round 1's plain pow of _HARD_EXP (cross-checked by
    tests/test_curves.py and the relic constants in
    tests/test_golden_vectors.py); ~70 cyclotomic squarings + a handful of
    Fp12 muls instead of a 4600-bit exponentiation."""
    # easy: f^(p^6 - 1) then ^(p^2 + 1)
    t2 = f.conjugate() * f.invert()
    t1 = t2
    t2 = t2.frobenius_map().frobenius_map() * t1
    # hard part
    t1 = cyclotomic_square(t2).conjugate()
    t3 = _cyclotomic_exp(t2)
    t4 = cyclotomic_square(t3)
    t5 = t1 * t3
    t1 = _cyclotomic_exp(t5)
    t0 = _cyclotomic_exp(t1)
    t6 = _cyclotomic_exp(t0) * t4
    t4 = _cyclotomic_exp(t6)
    t5 = t5.conjugate()
    t4 = t4 * t5 * t2
    t5 = t2.conjugate()
    t1 = (t1 * t2).frobenius_map().frobenius_map().frobenius_map()
    t6 = (t6 * t5).frobenius_map()
    t3 = (t3 * t0).frobenius_map().frobenius_map()
    t3 = t3 * t1 * t6
    return Gt(t3 * t4)


def pairing(p: G1Affine, q: G2Affine) -> Gt:
    if p.is_identity() or q.is_identity():
        return Gt.identity()
    return final_exponentiation(multi_miller_loop([(p, G2Prepared(q))]))
