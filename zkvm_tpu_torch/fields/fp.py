"""BLS12-381 base field Fp (381-bit). Reference parity: coset-bls12_381/src/fp.rs."""

from __future__ import annotations

from .. import params
from .field import PrimeField


class Fp(PrimeField):
    __slots__ = ()

    MODULUS = params.FP_MODULUS
    NUM_BYTES = 48
    R = params.FP_R
    TWO_ADICITY = 1  # p = 3 mod 4; sqrt uses the (p+1)/4 shortcut

    def lexicographically_largest(self) -> bool:
        """True iff the canonical value is > (p-1)/2 (fp.rs lexicographic flag)."""
        return self.value > ((self.MODULUS - 1) >> 1)

    # Reference Fp serializes big-endian (fp.rs to_bytes is BE!).
    def to_bytes(self) -> bytes:
        return self.value.to_bytes(48, "big")

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) != 48:
            return None
        v = int.from_bytes(buf, "big")
        if v >= cls.MODULUS:
            return None
        return cls(v)
