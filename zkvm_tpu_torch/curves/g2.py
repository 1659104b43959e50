"""G2 of BLS12-381 over Fp2 (host reference implementation).

Encodings: 96-byte compressed / 192-byte uncompressed, c1 || c0 big-endian,
flags in byte 0 (coset-bls12_381/src/g2.rs:493-787).  The psi-based
torsion-free check of g2.rs:931 is replaced by the equivalent full scalar
multiplication by q (same predicate, off the hot path).
"""

from __future__ import annotations

from .. import params
from ..fields import Fp, Fp2, Fr
from . import weierstrass as w

_B = Fp2(params.G1_B, params.G1_B)  # 4(u+1)
_B3 = _B + _B + _B


class G2Projective:
    __slots__ = ("x", "y", "z")

    def __init__(self, x: Fp2, y: Fp2, z: Fp2):
        self.x, self.y, self.z = x, y, z

    @classmethod
    def identity(cls):
        return cls(Fp2.zero(), Fp2.one(), Fp2.zero())

    @classmethod
    def generator(cls):
        return cls(
            Fp2(params.G2_GENERATOR_X0, params.G2_GENERATOR_X1),
            Fp2(params.G2_GENERATOR_Y0, params.G2_GENERATOR_Y1),
            Fp2.one(),
        )

    def is_identity(self) -> bool:
        return self.z.is_zero()

    def __add__(self, other):
        return G2Projective(*w.proj_add(Fp2, _B3, self.x, self.y, self.z,
                                        other.x, other.y, other.z))

    def double(self):
        return G2Projective(*w.proj_double(Fp2, _B3, self.x, self.y, self.z))

    def __neg__(self):
        return G2Projective(self.x, -self.y, self.z)

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, scalar):
        # raw ints are NOT reduced mod q: [q]P != identity off the subgroup
        k = scalar.value if isinstance(scalar, Fr) else int(scalar)
        ident = (Fp2.zero(), Fp2.one(), Fp2.zero())
        return G2Projective(*w.proj_mul(Fp2, _B3, self.x, self.y, self.z, k, ident))

    __rmul__ = __mul__

    def __eq__(self, other):
        if self.is_identity() or other.is_identity():
            return self.is_identity() and other.is_identity()
        return (self.x * other.z == other.x * self.z) and (
            self.y * other.z == other.y * self.z)

    def to_affine(self) -> "G2Affine":
        if self.is_identity():
            return G2Affine.identity()
        zinv = self.z.invert()
        return G2Affine(self.x * zinv, self.y * zinv)

    @staticmethod
    def batch_normalize(points: list["G2Projective"]) -> list["G2Affine"]:
        """Montgomery-trick batch affine conversion (g2.rs batch_normalize,
        same structure as G1)."""
        zs = [p.z for p in points]
        prefix, acc = [], Fp2.one()
        for z in zs:
            prefix.append(acc)
            if not z.is_zero():
                acc = acc * z
        inv = acc.invert()
        out = [None] * len(points)
        for i in range(len(points) - 1, -1, -1):
            if zs[i].is_zero():
                out[i] = G2Affine.identity()
            else:
                zi = prefix[i] * inv
                inv = inv * zs[i]
                out[i] = G2Affine(points[i].x * zi, points[i].y * zi)
        return out

    def is_on_curve(self) -> bool:
        return (self.y.square() * self.z ==
                self.x.square() * self.x + _B * self.z.square() * self.z) or self.z.is_zero()


class G2Affine:
    __slots__ = ("x", "y", "infinity")

    SIZE = 96

    def __init__(self, x: Fp2, y: Fp2, infinity: bool = False):
        self.x, self.y, self.infinity = x, y, infinity

    @classmethod
    def identity(cls):
        return cls(Fp2.zero(), Fp2.one(), True)

    @classmethod
    def generator(cls):
        return G2Projective.generator().to_affine()

    def to_projective(self) -> G2Projective:
        if self.infinity:
            return G2Projective.identity()
        return G2Projective(self.x, self.y, Fp2.one())

    def is_identity(self) -> bool:
        return self.infinity

    def __neg__(self):
        return G2Affine(self.x, -self.y, self.infinity)

    def __add__(self, other):
        return self.to_projective() + (other.to_projective() if isinstance(other, G2Affine) else other)

    def __mul__(self, scalar):
        return self.to_projective() * scalar

    __rmul__ = __mul__

    def __eq__(self, other):
        if not isinstance(other, G2Affine):
            return NotImplemented
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash(("G2", self.infinity,
                     self.x.c0.value, self.x.c1.value,
                     self.y.c0.value, self.y.c1.value))

    def is_on_curve(self) -> bool:
        return self.infinity or self.y.square() == self.x.square() * self.x + _B

    def is_torsion_free(self) -> bool:
        return (self.to_projective() * Fr.MODULUS).is_identity()

    # ---- encodings (g2.rs:493-710) -------------------------------------------
    def to_compressed(self) -> bytes:
        x = Fp2.zero() if self.infinity else self.x
        buf = bytearray(x.c1.to_bytes() + x.c0.to_bytes())
        buf[0] |= 0x80
        if self.infinity:
            buf[0] |= 0x40
        elif self.y.lexicographically_largest():
            buf[0] |= 0x20
        return bytes(buf)

    to_bytes = to_compressed

    def to_uncompressed(self) -> bytes:
        if self.infinity:
            buf = bytearray(192)
            buf[0] |= 0x40
            return bytes(buf)
        return (self.x.c1.to_bytes() + self.x.c0.to_bytes()
                + self.y.c1.to_bytes() + self.y.c0.to_bytes())

    @classmethod
    def from_compressed(cls, buf: bytes, check_subgroup: bool = True):
        if len(buf) != 96:
            return None
        compression = (buf[0] >> 7) & 1
        infinity = (buf[0] >> 6) & 1
        sort = (buf[0] >> 5) & 1
        if not compression:
            return None
        c1_body = bytes([buf[0] & 0x1F]) + buf[1:48]
        if infinity:
            if sort or any(c1_body) or any(buf[48:]):
                return None
            return cls.identity()
        xc1 = Fp.from_bytes(c1_body)
        xc0 = Fp.from_bytes(buf[48:])
        if xc1 is None or xc0 is None:
            return None
        x = Fp2(xc0, xc1)
        y = (x.square() * x + _B).sqrt()
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
        if len(buf) != 192:
            return None
        compression = (buf[0] >> 7) & 1
        infinity = (buf[0] >> 6) & 1
        sort = (buf[0] >> 5) & 1
        if compression:
            return None
        c1_body = bytes([buf[0] & 0x1F]) + buf[1:48]
        if infinity:
            if sort or any(c1_body) or any(buf[48:]):
                return None
            return cls.identity()
        xc1, xc0 = Fp.from_bytes(c1_body), Fp.from_bytes(buf[48:96])
        yc1, yc0 = Fp.from_bytes(buf[96:144]), Fp.from_bytes(buf[144:])
        if None in (xc1, xc0, yc1, yc0) or sort:
            return None
        p = cls(Fp2(xc0, xc1), Fp2(yc0, yc1))
        if check and (not p.is_on_curve() or not p.is_torsion_free()):
            return None
        return p

    def __repr__(self):
        return "G2Affine(identity)" if self.infinity else f"G2Affine(x={self.x!r})"


def _psi(p: G2Projective) -> G2Projective:
    """Untwist-Frobenius-twist endomorphism (g2.rs:848-887)."""
    from .h2c_g2_constants import (PSI_COEFF_X_C1, PSI_COEFF_Y_C0,
                                   PSI_COEFF_Y_C1)

    cx = Fp2(Fp.zero(), Fp(PSI_COEFF_X_C1))
    cy = Fp2(Fp(PSI_COEFF_Y_C0), Fp(PSI_COEFF_Y_C1))
    return G2Projective(p.x.frobenius_map() * cx,
                        p.y.frobenius_map() * cy,
                        p.z.frobenius_map())


def _psi2(p: G2Projective) -> G2Projective:
    """psi composed with itself (g2.rs:889-909)."""
    from .h2c_g2_constants import PSI2_COEFF_X_C0

    cx = Fp2(Fp(PSI2_COEFF_X_C0), Fp.zero())
    return G2Projective(p.x * cx, -p.y, p.z)


def _mul_by_x(p: G2Projective) -> G2Projective:
    """Multiply by the (negative) BLS parameter x (g2.rs:911-928)."""
    res = p * params.BLS_X
    return -res if params.BLS_X_IS_NEGATIVE else res


def clear_cofactor_g2(p: G2Projective) -> G2Projective:
    """Efficient psi-based cofactor clearing (g2.rs:931-936):
    [x^2-x-1]P + [x-1]psi(P) + psi2(2P)."""
    t1 = _mul_by_x(p)
    t2 = _psi(p)
    return (_psi2(p.double()) + _mul_by_x(t1 + t2)) - t1 - t2 - p


G2Projective.psi = _psi
G2Projective.psi2 = _psi2
G2Projective.mul_by_x = _mul_by_x
G2Projective.clear_cofactor = clear_cofactor_g2
