"""Dense polynomial over Fr (plonk/src/fft/polynomial.rs parity)."""

from __future__ import annotations

from ..fields import Fr

_Q = Fr.MODULUS


class Polynomial:
    """Dense coefficient vector, lowest degree first."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs=None):
        self.coeffs: list[Fr] = list(coeffs) if coeffs else []
        self._truncate_leading_zeros()

    def _truncate_leading_zeros(self):
        while self.coeffs and self.coeffs[-1].is_zero():
            self.coeffs.pop()

    @classmethod
    def zero(cls):
        return cls([])

    @classmethod
    def from_coefficients(cls, coeffs):
        return cls(coeffs)

    def is_zero(self) -> bool:
        return not self.coeffs

    def degree(self) -> int:
        return max(0, len(self.coeffs) - 1)

    def __len__(self):
        return len(self.coeffs)

    def __getitem__(self, i):
        return self.coeffs[i]

    def __eq__(self, other):
        return isinstance(other, Polynomial) and self.coeffs == other.coeffs

    def evaluate(self, point: Fr) -> Fr:
        """Horner evaluation (polynomial.rs evaluate)."""
        acc, x = 0, point.value
        for c in reversed(self.coeffs):
            acc = (acc * x + c.value) % _Q
        return Fr(acc)

    def __add__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [Fr.zero()] * (n - len(self.coeffs))
        b = other.coeffs + [Fr.zero()] * (n - len(other.coeffs))
        return Polynomial([x + y for x, y in zip(a, b)])

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [Fr.zero()] * (n - len(self.coeffs))
        b = other.coeffs + [Fr.zero()] * (n - len(other.coeffs))
        return Polynomial([x - y for x, y in zip(a, b)])

    def __neg__(self):
        return Polynomial([-c for c in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, Fr):
            return self.scale(other)
        if self.is_zero() or other.is_zero():
            return Polynomial.zero()
        out = [0] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            av = a.value
            if av == 0:
                continue
            for j, b in enumerate(other.coeffs):
                out[i + j] = (out[i + j] + av * b.value) % _Q
        return Polynomial([Fr(v) for v in out])

    __rmul__ = __mul__

    def scale(self, s: Fr) -> "Polynomial":
        sv = s.value
        return Polynomial([Fr(c.value * sv % _Q) for c in self.coeffs])

    def ruffini(self, z: Fr) -> "Polynomial":
        """Synthetic division by (X - z) (polynomial.rs:343), drops remainder."""
        if self.is_zero():
            return Polynomial.zero()
        out = []
        k = 0
        for c in reversed(self.coeffs):
            k = (k * z.value + c.value) % _Q
            out.append(k)
        out.reverse()
        return Polynomial([Fr(v) for v in out[1:]])

    def __repr__(self):
        return f"Polynomial(deg={self.degree()}, n={len(self.coeffs)})"
