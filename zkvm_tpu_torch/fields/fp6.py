"""Fp6 = Fp2[v] / (v^3 - (u+1)). Reference parity: coset-bls12_381/src/fp6.rs."""

from __future__ import annotations

from .fp import Fp
from .fp2 import Fp2

# Frobenius coefficients: (u+1)^((p-1)/3) and (u+1)^((2p-2)/3), computed once.
_P = Fp.MODULUS


def _fp2_pow(base: Fp2, e: int) -> Fp2:
    return base.pow(e)


_XI = Fp2(1, 1)  # u + 1
FROBENIUS_COEFF_FP6_C1 = _fp2_pow(_XI, (_P - 1) // 3)
FROBENIUS_COEFF_FP6_C2 = _fp2_pow(_XI, (2 * _P - 2) // 3)


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2 | None = None, c1: Fp2 | None = None, c2: Fp2 | None = None):
        self.c0 = c0 if c0 is not None else Fp2.zero()
        self.c1 = c1 if c1 is not None else Fp2.zero()
        self.c2 = c2 if c2 is not None else Fp2.zero()

    @classmethod
    def zero(cls):
        return cls()

    @classmethod
    def one(cls):
        return cls(Fp2.one(), Fp2.zero(), Fp2.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other):
        return (
            isinstance(other, Fp6)
            and self.c0 == other.c0
            and self.c1 == other.c1
            and self.c2 == other.c2
        )

    def __add__(self, other):
        return Fp6(self.c0 + other.c0, self.c1 + other.c1, self.c2 + other.c2)

    def __sub__(self, other):
        return Fp6(self.c0 - other.c0, self.c1 - other.c1, self.c2 - other.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, other):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = other.c0, other.c1, other.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        """Multiply by v: (c0, c1, c2) -> (c2 * xi, c0, c1)."""
        return Fp6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def mul_by_fp2(self, s: Fp2):
        return Fp6(self.c0 * s, self.c1 * s, self.c2 * s)

    def mul_by_01(self, b0: Fp2, b1: Fp2):
        t0 = self.c0 * b0
        t1 = self.c1 * b1
        c0 = ((self.c1 + self.c2) * b1 - t1).mul_by_nonresidue() + t0
        c1 = (b0 + b1) * (self.c0 + self.c1) - t0 - t1
        c2 = self.c2 * b0 + t1
        return Fp6(c0, c1, c2)

    def mul_by_1(self, b1: Fp2):
        return Fp6(
            ((self.c1 + self.c2) * b1 - self.c1 * b1).mul_by_nonresidue(),
            self.c0 * b1,
            self.c1 * b1,
        )

    def frobenius_map(self):
        c0 = self.c0.frobenius_map()
        c1 = self.c1.frobenius_map() * FROBENIUS_COEFF_FP6_C1
        c2 = self.c2.frobenius_map() * FROBENIUS_COEFF_FP6_C2
        return Fp6(c0, c1, c2)

    def invert(self):
        c0 = self.c0.square() - (self.c1 * self.c2).mul_by_nonresidue()
        c1 = self.c2.square().mul_by_nonresidue() - self.c0 * self.c1
        c2 = self.c1.square() - self.c0 * self.c2
        t = ((self.c2 * c1 + self.c1 * c2).mul_by_nonresidue() + self.c0 * c0).invert()
        if t is None:
            return None
        return Fp6(c0 * t, c1 * t, c2 * t)

    def __repr__(self):
        return f"Fp6({self.c0!r}, {self.c1!r}, {self.c2!r})"
