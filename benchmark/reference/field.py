"""BLS12-381 moduli and the scalar helpers of the reference (plain ints)."""

from __future__ import annotations

import hashlib

# scalar field r (the NTT field) and base field p of BLS12-381
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
TWO_ADICITY = 32
ROOT_OF_UNITY = pow(7, (R - 1) >> TWO_ADICITY, R)  # generator 7
MONT_R_INV = pow(1 << 256, -1, R)  # a Montgomery word m stands for m R^-1

# the PLONK permutation's coset constants (dusk-plonk permutation/constants.rs)
K1, K2, K3 = 7, 13, 17


def from_bytes_wide(buf: bytes) -> int:
    """A 64-byte little-endian value reduced mod r (Scalar::from_bytes_wide)."""
    return int.from_bytes(buf, "little") % R


def random_scalar(rng) -> int:
    """Scalar::random: 64 bytes of the stream, wide-reduced."""
    return from_bytes_wide(rng.randbytes(64))


def hash_to_scalar(data: bytes) -> int:
    """BlsScalar::hash_to_scalar: BLAKE2b-512 reduced mod r."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=64).digest(),
                          "little") % R


def scalar_from_bytes(buf: bytes) -> int | None:
    """Canonical 32-byte little-endian scalar, None if not below r."""
    v = int.from_bytes(buf, "little")
    return v if len(buf) == 32 and v < R else None


def root_of_unity(n: int) -> int:
    """The generator of the order-n subgroup (n a power of two)."""
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - (n.bit_length() - 1)), R)


def batch_inverse(values: list[int]) -> list[int]:
    """Inverses mod r of nonzero values, with one exponentiation."""
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % R
    inv = pow(prefix[-1], -1, R)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * values[i] % R
    return out
