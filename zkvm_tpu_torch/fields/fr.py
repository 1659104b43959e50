"""BLS12-381 scalar field Fr ("BlsScalar") -- the NTT field.

Reference parity: coset-bls12_381/src/scalar.rs and scalar/coset.rs.
"""

from __future__ import annotations

import hashlib

from .. import params
from .field import PrimeField


class Fr(PrimeField):
    __slots__ = ()

    MODULUS = params.FR_MODULUS
    NUM_BYTES = 32
    R = params.FR_R
    R2 = params.FR_R2
    R3 = params.FR_R3
    TWO_ADICITY = params.FR_TWO_ADICITY
    ROOT_OF_UNITY = params.FR_ROOT_OF_UNITY
    GENERATOR = params.FR_GENERATOR

    @classmethod
    def hash_to_scalar(cls, data: bytes) -> "Fr":
        """Blake2b-512 of the input, reduced as a 512-bit LE integer.

        Mirrors scalar/coset.rs:260 (blake2b_simd with hash_length 64 and then
        reduce_u512_words of the LE words).
        """
        digest = hashlib.blake2b(data, digest_size=64).digest()
        return cls(int.from_bytes(digest, "little"))

    @classmethod
    def pow_of_2(cls, by: int) -> "Fr":
        return cls(pow(2, by, cls.MODULUS))


# Convenience aliases used throughout the framework (the reference exports
# `BlsScalar` as the primary name).
BlsScalar = Fr
