"""Fp2 = Fp[u] / (u^2 + 1). Reference parity: coset-bls12_381/src/fp2.rs."""

from __future__ import annotations

from .fp import Fp


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp | int = 0, c1: Fp | int = 0):
        self.c0 = c0 if isinstance(c0, Fp) else Fp(c0)
        self.c1 = c1 if isinstance(c1, Fp) else Fp(c1)

    @classmethod
    def zero(cls):
        return cls(0, 0)

    @classmethod
    def one(cls):
        return cls(1, 0)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, other):
        return isinstance(other, Fp2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash(("Fp2", self.c0.value, self.c1.value))

    def __add__(self, other):
        return Fp2(self.c0 + other.c0, self.c1 + other.c1)

    def __sub__(self, other):
        return Fp2(self.c0 - other.c0, self.c1 - other.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, other):
        # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
        a0, a1, b0, b1 = self.c0, self.c1, other.c0, other.c1
        return Fp2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    def square(self):
        a0, a1 = self.c0, self.c1
        # (a0+a1)(a0-a1) + (2 a0 a1) u
        return Fp2((a0 + a1) * (a0 - a1), (a0 * a1).double())

    def mul_by_fp(self, s: Fp):
        return Fp2(self.c0 * s, self.c1 * s)

    def mul_by_nonresidue(self):
        """Multiply by (u + 1): (c0 - c1) + (c0 + c1) u (fp2.rs)."""
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def conjugate(self):
        return Fp2(self.c0, -self.c1)

    def frobenius_map(self):
        # (a + bu)^p = a - bu since u^2 = -1 and p = 3 mod 4
        return self.conjugate()

    def invert(self):
        # 1/(a + bu) = (a - bu)/(a^2 + b^2)
        norm = self.c0.square() + self.c1.square()
        inv = norm.invert()
        if inv is None:
            return None
        return Fp2(self.c0 * inv, -(self.c1 * inv))

    def sqrt(self):
        """Deterministic Fp2 square root (fp2.rs sqrt, p^2 = 9 mod 16 method)."""
        if self.is_zero():
            return Fp2.zero()
        # a1 = self^((p-2)/4)? Use the standard bls12_381 algorithm:
        p = Fp.MODULUS
        a1 = self.pow((p - 3) >> 2)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha == Fp2(-Fp.one(), Fp.zero()):
            res = Fp2(-x0.c1, x0.c0)  # x0 * u
        else:
            b = (alpha + Fp2.one()).pow((p - 1) >> 1)
            res = b * x0
        return res if res.square() == self else None

    def pow(self, e: int):
        r = Fp2.one()
        b = self
        while e > 0:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def lexicographically_largest(self) -> bool:
        """fp2.rs: c1 largest, or (c1 zero and c0 largest)."""
        return self.c1.lexicographically_largest() or (
            self.c1.is_zero() and self.c0.lexicographically_largest()
        )

    def __repr__(self):
        return f"Fp2({self.c0!r} + {self.c1!r}*u)"

    def sqrt(self):
        """Square root in Fp2 for p = 3 mod 4 (g2.rs sqrt algorithm):
        a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0;
        alpha == -1 -> i*x0, else (1+alpha)^((p-1)/2) * x0."""
        if self.is_zero():
            return Fp2.zero()
        p = Fp.MODULUS
        a1 = self.pow((p - 3) // 4)
        x0 = a1 * self
        alpha = a1 * x0
        if alpha == -Fp2.one():
            candidate = Fp2(Fp.zero(), Fp.one()) * x0
        else:
            candidate = (Fp2.one() + alpha).pow((p - 1) // 2) * x0
        if candidate.square() == self:
            return candidate
        return None
