"""G1 of BLS12-381 (host reference implementation).

Encodings follow the Zcash/IETF format the reference uses
(coset-bls12_381/src/g1.rs:624-782): 48-byte compressed / 96-byte
uncompressed, big-endian Fp, flag bits in the three MSBs of byte 0
(compression, infinity, y-sign).
"""

from __future__ import annotations

from .. import params
from ..fields import Fp, Fr
from . import weierstrass as w

_B = Fp(params.G1_B)
_B3 = Fp(3 * params.G1_B)
# effective cofactor multiplier: clear_cofactor = [1 - x]P = [1 + |x|]P (g1.rs:701)
_H_EFF = 1 + params.BLS_X


class G1Projective:
    """Homogeneous projective point (complete RCB15 group law)."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: Fp, y: Fp, z: Fp):
        self.x, self.y, self.z = x, y, z

    @classmethod
    def identity(cls):
        return cls(Fp.zero(), Fp.one(), Fp.zero())

    @classmethod
    def generator(cls):
        return cls(Fp(params.G1_GENERATOR_X), Fp(params.G1_GENERATOR_Y), Fp.one())

    def is_identity(self) -> bool:
        return self.z.is_zero()

    def __add__(self, other: "G1Projective") -> "G1Projective":
        return G1Projective(*w.proj_add(Fp, _B3, self.x, self.y, self.z,
                                        other.x, other.y, other.z))

    def add_mixed(self, other: "G1Affine") -> "G1Projective":
        if other.infinity:
            return self
        return self + other.to_projective()

    def double(self) -> "G1Projective":
        return G1Projective(*w.proj_double(Fp, _B3, self.x, self.y, self.z))

    def __neg__(self):
        return G1Projective(self.x, -self.y, self.z)

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, scalar) -> "G1Projective":
        # raw ints are NOT reduced mod q: [q]P != identity off the subgroup
        k = scalar.value if isinstance(scalar, Fr) else int(scalar)
        ident = (Fp.zero(), Fp.one(), Fp.zero())
        return G1Projective(*w.proj_mul(Fp, _B3, self.x, self.y, self.z, k, ident))

    __rmul__ = __mul__

    def __eq__(self, other):
        # (x1/z1 == x2/z2) and (y1/z1 == y2/z2), identity-aware
        if self.is_identity() or other.is_identity():
            return self.is_identity() and other.is_identity()
        return (self.x * other.z == other.x * self.z) and (
            self.y * other.z == other.y * self.z)

    def __hash__(self):
        return hash(self.to_affine())

    def mul_by_x(self) -> "G1Projective":
        """Multiply by the (negative) BLS parameter x."""
        res = self * params.BLS_X
        return -res if params.BLS_X_IS_NEGATIVE else res

    def clear_cofactor(self) -> "G1Projective":
        return self * _H_EFF

    def to_affine(self) -> "G1Affine":
        if self.is_identity():
            return G1Affine.identity()
        zinv = self.z.invert()
        return G1Affine(self.x * zinv, self.y * zinv)

    @staticmethod
    def batch_normalize(points: list["G1Projective"]) -> list["G1Affine"]:
        """Montgomery-trick batch affine conversion (g1.rs:784)."""
        zs = [p.z for p in points]
        # batch invert, zeros (identities) map to zero
        prefix, acc = [], Fp.one()
        for z in zs:
            prefix.append(acc)
            if not z.is_zero():
                acc = acc * z
        inv = acc.invert()
        out = [None] * len(points)
        for i in range(len(points) - 1, -1, -1):
            if zs[i].is_zero():
                out[i] = G1Affine.identity()
            else:
                zi = prefix[i] * inv
                inv = inv * zs[i]
                out[i] = G1Affine(points[i].x * zi, points[i].y * zi)
        return out

    def is_on_curve(self) -> bool:
        # y^2 z = x^3 + b z^3 (projective curve equation) or identity
        return (self.y.square() * self.z ==
                self.x.square() * self.x + _B * self.z.square() * self.z) or self.z.is_zero()

    def __repr__(self):
        a = self.to_affine()
        return f"G1Projective({a!r})"


class G1Affine:
    __slots__ = ("x", "y", "infinity")

    SIZE = 48  # compressed

    def __init__(self, x: Fp, y: Fp, infinity: bool = False):
        self.x, self.y, self.infinity = x, y, infinity

    @classmethod
    def identity(cls):
        return cls(Fp.zero(), Fp.one(), True)

    @classmethod
    def generator(cls):
        return cls(Fp(params.G1_GENERATOR_X), Fp(params.G1_GENERATOR_Y))

    def to_projective(self) -> G1Projective:
        if self.infinity:
            return G1Projective.identity()
        return G1Projective(self.x, self.y, Fp.one())

    def is_identity(self) -> bool:
        return self.infinity

    def __neg__(self):
        return G1Affine(self.x, -self.y, self.infinity)

    def __add__(self, other):
        return self.to_projective() + (other.to_projective() if isinstance(other, G1Affine) else other)

    def __mul__(self, scalar):
        return self.to_projective() * scalar

    __rmul__ = __mul__

    def __eq__(self, other):
        if not isinstance(other, G1Affine):
            return NotImplemented
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash(("G1", self.infinity, self.x.value, self.y.value))

    def is_on_curve(self) -> bool:
        return self.infinity or self.y.square() == self.x.square() * self.x + _B

    def is_torsion_free(self) -> bool:
        """Full subgroup check: [q]P == identity (g1.rs subgroup check)."""
        return (self.to_projective() * Fr.MODULUS).is_identity()

    # ---- encodings (g1.rs:624-700) -------------------------------------------
    def to_compressed(self) -> bytes:
        buf = bytearray((Fp.zero() if self.infinity else self.x).to_bytes())
        buf[0] |= 0x80  # compression flag
        if self.infinity:
            buf[0] |= 0x40
        elif self.y.lexicographically_largest():
            buf[0] |= 0x20
        return bytes(buf)

    def to_uncompressed(self) -> bytes:
        if self.infinity:
            buf = bytearray(96)
            buf[0] |= 0x40
            return bytes(buf)
        return self.x.to_bytes() + self.y.to_bytes()

    to_bytes = to_compressed

    @classmethod
    def from_compressed(cls, buf: bytes, check_subgroup: bool = True):
        if len(buf) != 48:
            return None
        compression = (buf[0] >> 7) & 1
        infinity = (buf[0] >> 6) & 1
        sort = (buf[0] >> 5) & 1
        if not compression:
            return None
        body = bytes([buf[0] & 0x1F]) + buf[1:]
        if infinity:
            if sort or any(body):
                return None
            return cls.identity()
        x = Fp.from_bytes(body)
        if x is None:
            return None
        y2 = x.square() * x + _B
        y = y2.sqrt()
        if y is None:
            return None
        if y.lexicographically_largest() != bool(sort):
            y = -y
        p = cls(x, y)
        if check_subgroup and not p.is_torsion_free():
            return None
        return p

    from_bytes = from_compressed

    @classmethod
    def from_uncompressed(cls, buf: bytes, check: bool = True):
        if len(buf) != 96:
            return None
        compression = (buf[0] >> 7) & 1
        infinity = (buf[0] >> 6) & 1
        sort = (buf[0] >> 5) & 1
        if compression:
            return None
        body = bytes([buf[0] & 0x1F]) + buf[1:48]
        if infinity:
            if sort or any(body) or any(buf[48:]):
                return None
            return cls.identity()
        x = Fp.from_bytes(body)
        y = Fp.from_bytes(buf[48:])
        if x is None or y is None or sort:
            return None
        p = cls(x, y)
        if check and (not p.is_on_curve() or not p.is_torsion_free()):
            return None
        return p

    # raw (unchecked) format used by CommitKey raw serialization:
    # g1/coset.rs:8-48 stores the *Montgomery-form* limbs (internal_repr) of
    # x and y little-endian, then one infinity tag byte.
    RAW_SIZE = 97

    def to_raw_bytes(self) -> bytes:
        return (self.x.mont_value().to_bytes(48, "little")
                + self.y.mont_value().to_bytes(48, "little")
                + (b"\x01" if self.infinity else b"\x00"))

    @classmethod
    def from_slice_unchecked(cls, buf: bytes) -> "G1Affine":
        rinv = pow(Fp.R, -1, Fp.MODULUS)
        x = Fp(int.from_bytes(buf[:48], "little") * rinv)
        y = Fp(int.from_bytes(buf[48:96], "little") * rinv)
        infinity = bool(buf[96]) if len(buf) >= 97 else False
        return cls(x, y, infinity)

    def __repr__(self):
        if self.infinity:
            return "G1Affine(identity)"
        return f"G1Affine(x=0x{self.x.value:x}, y=0x{self.y.value:x})"
