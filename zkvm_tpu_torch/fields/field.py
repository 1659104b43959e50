"""Generic prime-field element over Python ints.

Semantics mirror the reference field types (coset-bls12_381/src/scalar.rs,
fp.rs; coset-jubjub/src/fr.rs) but store canonical integers -- Montgomery form
only exists on the device side (zkvm_tpu/ops), and in `mont_value()` for the
few places where the reference's Montgomery-limb byte order is observable
(`Ord`, circuit compression tables).
"""

from __future__ import annotations


class PrimeField:
    """Base class; concrete fields subclass and set class attributes.

    Class attributes required:
      MODULUS: int       -- the prime p
      NUM_BYTES: int     -- canonical little-endian encoding size
      R: int             -- Montgomery radix 2^(8*NUM_BYTES... actually 2^(64*ceil)) mod p
      TWO_ADICITY: int
      ROOT_OF_UNITY: int -- canonical value (only meaningful for NTT fields)
    """

    __slots__ = ("value",)

    MODULUS: int = 0
    NUM_BYTES: int = 32
    R: int = 0
    TWO_ADICITY: int = 0
    ROOT_OF_UNITY: int = 0

    def __init__(self, value: int = 0):
        self.value = value % self.MODULUS

    # -- constructors ---------------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_raw(cls, limbs_or_int):
        """Accepts an int or a sequence of 4/6 little-endian u64 limbs.

        Mirrors `Scalar::from_raw` (scalar.rs): interpret as a canonical
        integer (reduced mod p).
        """
        if isinstance(limbs_or_int, int):
            return cls(limbs_or_int)
        v = 0
        for i, limb in enumerate(limbs_or_int):
            v |= int(limb) << (64 * i)
        return cls(v)

    @classmethod
    def from_bytes(cls, buf: bytes):
        """Canonical little-endian decoding; None if >= MODULUS.

        Mirrors `Scalar::from_bytes` returning CtOption (scalar.rs:244).
        """
        if len(buf) != cls.NUM_BYTES:
            return None
        v = int.from_bytes(buf, "little")
        if v >= cls.MODULUS:
            return None
        return cls(v)

    @classmethod
    def from_bytes_wide(cls, buf: bytes):
        """Reduce a 2*NUM_BYTES little-endian value mod p (scalar.rs from_u512)."""
        assert len(buf) == 2 * cls.NUM_BYTES
        return cls(int.from_bytes(buf, "little"))

    @classmethod
    def from_u64(cls, v: int):
        return cls(v)

    @classmethod
    def from_hex_str(cls, s: str):
        """coset-bytes ParseHexStr: hex string of the canonical LE bytes."""
        if s.startswith(("0x", "0X")):
            s = s[2:]
        raw = bytes.fromhex(s)
        return cls.from_bytes(raw)

    @classmethod
    def random(cls, rng):
        """Draw from 2*NUM_BYTES uniform bytes, wide-reduced.

        `rng` is anything with a `.randbytes(n)`/`fill_bytes` style method; we
        accept objects exposing `randbytes` (python random.Random and our
        rust-compatible RNGs in zkvm_tpu.rng).
        """
        return cls.from_bytes_wide(rng.randbytes(2 * cls.NUM_BYTES))

    # -- serialization --------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.value.to_bytes(self.NUM_BYTES, "little")

    def to_be_bytes(self) -> bytes:
        return self.value.to_bytes(self.NUM_BYTES, "big")

    def to_bits(self):
        """LSB-first bit vector of the canonical encoding (scalar/coset.rs:219)."""
        return [(self.value >> i) & 1 for i in range(8 * self.NUM_BYTES)]

    def to_hex_str(self) -> str:
        return "0x" + self.to_bytes().hex()

    def mont_value(self) -> int:
        """The canonical integer of the Montgomery representation (value*R mod p).

        This is what the reference stores in its limb array; its byte order is
        observable through `Ord` and the compression scalar table.
        """
        return (self.value * self.R) % self.MODULUS

    def mont_limbs_u64(self):
        m = self.mont_value()
        n = self.NUM_BYTES // 8
        return [(m >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, other):
        return type(self)(self.value + other.value)

    def __sub__(self, other):
        return type(self)(self.value - other.value)

    def __neg__(self):
        return type(self)(-self.value)

    def __mul__(self, other):
        return type(self)(self.value * other.value)

    def square(self):
        return type(self)(self.value * self.value)

    def double(self):
        return type(self)(self.value << 1)

    def pow(self, e: int):
        return type(self)(pow(self.value, e, self.MODULUS))

    def invert(self):
        """Multiplicative inverse; None for zero (matches CtOption semantics)."""
        if self.value == 0:
            return None
        return type(self)(pow(self.value, -1, self.MODULUS))

    def sqrt(self):
        """Deterministic square root (Tonelli-Shanks); None if non-residue.

        Matches ff::helpers::sqrt_tonelli_shanks (used by scalar.rs:632) for
        2-adic fields and the (p+1)/4 shortcut for p = 3 mod 4.
        """
        p = self.MODULUS
        if self.value == 0:
            return type(self)(0)
        if p % 4 == 3:
            r = pow(self.value, (p + 1) >> 2, p)
            return type(self)(r) if (r * r) % p == self.value else None
        # Tonelli-Shanks, deterministic with the field's ROOT_OF_UNITY as z.
        s = self.TWO_ADICITY
        t = (p - 1) >> s
        w = pow(self.value, (t - 1) >> 1, p)
        x = self.value * w % p          # f^((t+1)/2)
        b = x * w % p                   # f^t
        z = self.ROOT_OF_UNITY % p      # 2^s-th root generator
        v = s
        while b != 1:
            # find least k with b^(2^k) == 1
            k = 0
            b2k = b
            while b2k != 1:
                b2k = b2k * b2k % p
                k += 1
            if k == v:
                return None  # non-residue
            # z <- z^(2^(v-k-1))
            for _ in range(v - k - 1):
                z = z * z % p
            x = x * z % p
            z = z * z % p
            b = b * z % p
            v = k
        return type(self)(x)

    # -- comparisons / misc ----------------------------------------------------
    def __eq__(self, other):
        return isinstance(other, PrimeField) and type(other) is type(self) and self.value == other.value

    def __hash__(self):
        return hash((type(self).__name__, self.value))

    def __lt__(self, other):
        """Reference `Ord` compares the Montgomery limb array (scalar/coset.rs:18)."""
        return self.mont_value() < other.mont_value()

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        return other < self

    def __ge__(self, other):
        return self == other or other < self

    def __and__(self, other):
        """Bitwise AND of canonical values (scalar/coset.rs:184)."""
        return type(self)(self.value & other.value)

    def __xor__(self, other):
        return type(self)(self.value ^ other.value)

    def is_zero(self) -> bool:
        return self.value == 0

    def is_one(self) -> bool:
        return self.value == 1

    def reduce(self):
        """Identity here (we store canonical); kept for API parity."""
        return self

    def divn(self, n: int):
        """Right-shift the canonical value by n bits (scalar/coset.rs:282)."""
        return type(self)(self.value >> n) if n < 8 * self.NUM_BYTES else type(self)(0)

    def __repr__(self):
        return f"0x{self.value:0{2 * self.NUM_BYTES}x}"

    def __int__(self):
        return self.value

    def __bool__(self):
        return self.value != 0
