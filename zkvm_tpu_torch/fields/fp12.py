"""Fp12 = Fp6[w] / (w^2 - v). Reference parity: coset-bls12_381/src/fp12.rs."""

from __future__ import annotations

from .fp import Fp
from .fp2 import Fp2
from .fp6 import Fp6

_P = Fp.MODULUS
FROBENIUS_COEFF_FP12_C1 = Fp2(1, 1).pow((_P - 1) // 6)  # (u+1)^((p-1)/6)


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6 | None = None, c1: Fp6 | None = None):
        self.c0 = c0 if c0 is not None else Fp6.zero()
        self.c1 = c1 if c1 is not None else Fp6.zero()

    @classmethod
    def zero(cls):
        return cls()

    @classmethod
    def one(cls):
        return cls(Fp6.one(), Fp6.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def is_one(self):
        return self == Fp12.one()

    def __eq__(self, other):
        return isinstance(other, Fp12) and self.c0 == other.c0 and self.c1 == other.c1

    def __add__(self, other):
        return Fp12(self.c0 + other.c0, self.c1 + other.c1)

    def __sub__(self, other):
        return Fp12(self.c0 - other.c0, self.c1 - other.c1)

    def __neg__(self):
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, other):
        aa = self.c0 * other.c0
        bb = self.c1 * other.c1
        c1 = (self.c1 + self.c0) * (other.c0 + other.c1) - aa - bb
        c0 = bb.mul_by_nonresidue() + aa
        return Fp12(c0, c1)

    def square(self):
        ab = self.c0 * self.c1
        c0c1 = self.c0 + self.c1
        c0 = (self.c1.mul_by_nonresidue() + self.c0) * c0c1 - ab - ab.mul_by_nonresidue()
        c1 = ab + ab
        return Fp12(c0, c1)

    def mul_by_014(self, c0: Fp2, c1: Fp2, c4: Fp2):
        """Sparse multiplication used by the Miller loop (fp12.rs mul_by_014)."""
        aa = self.c0.mul_by_01(c0, c1)
        bb = self.c1.mul_by_1(c4)
        o = c1 + c4
        new_c1 = (self.c1 + self.c0).mul_by_01(c0, o) - aa - bb
        new_c0 = bb.mul_by_nonresidue() + aa
        return Fp12(new_c0, new_c1)

    def conjugate(self):
        return Fp12(self.c0, -self.c1)

    def frobenius_map(self):
        c0 = self.c0.frobenius_map()
        c1 = self.c1.frobenius_map()
        c1 = Fp6(
            c1.c0 * FROBENIUS_COEFF_FP12_C1,
            c1.c1 * FROBENIUS_COEFF_FP12_C1,
            c1.c2 * FROBENIUS_COEFF_FP12_C1,
        )
        return Fp12(c0, c1)

    def invert(self):
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).invert()
        if t is None:
            return None
        return Fp12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        r = Fp12.one()
        b = self
        while e > 0:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def __repr__(self):
        return f"Fp12({self.c0!r}, {self.c1!r})"
