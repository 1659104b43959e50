"""Pointwise polynomial evaluations over a domain (plonk/src/fft/evaluations.rs)."""

from __future__ import annotations

from ..fields import Fr
from ..ops.ntt import Domain, _batch_inverse
from .polynomial import Polynomial

_Q = Fr.MODULUS


class Evaluations:
    """Evaluation vector over `domain` (evaluations.rs:30-151)."""

    __slots__ = ("evals", "domain")

    def __init__(self, evals, domain: Domain):
        self.evals: list[Fr] = list(evals)
        self.domain = domain

    @classmethod
    def from_vec_and_domain(cls, evals, domain: Domain) -> "Evaluations":
        return cls(evals, domain)

    def interpolate(self, device) -> Polynomial:
        return Polynomial(self.domain.ifft(self.evals, device))

    def __getitem__(self, i):
        return self.evals[i]

    def __len__(self):
        return len(self.evals)

    def __eq__(self, other):
        return (isinstance(other, Evaluations) and self.domain is other.domain
                and self.evals == other.evals)

    def _zip(self, other):
        assert self.domain is other.domain, "domains must match"
        return zip(self.evals, other.evals)

    def __add__(self, other):
        return Evaluations([a + b for a, b in self._zip(other)], self.domain)

    def __sub__(self, other):
        return Evaluations([a - b for a, b in self._zip(other)], self.domain)

    def __mul__(self, other):
        return Evaluations([a * b for a, b in self._zip(other)], self.domain)

    def __truediv__(self, other):
        invs = _batch_inverse([b.value for b in other.evals], _Q)
        return Evaluations(
            [Fr(a.value * inv % _Q) for a, inv in zip(self.evals, invs)],
            self.domain)
