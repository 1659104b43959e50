"""Jubjub: twisted Edwards curve over the BLS12-381 scalar field.

-u^2 + v^2 = 1 + d u^2 v^2, d = -(10240/10241).  Extended coordinates with
cached t1*t2 = t (coset-jubjub/src/lib.rs:73-365), Niels-point addition,
32-byte encoding (v little-endian, sign of u in the top bit), ElGamal, DHKE,
and the hash-to-point / scalar embedding helpers of coset.rs:25-233.
"""

from __future__ import annotations

import hashlib

from .. import params
from ..fields import Fr as Fq  # Jubjub's base field IS the BLS scalar field
from ..fields import JubjubFr

_D = params.JUBJUB_D
_Q = Fq.MODULUS
_D2 = 2 * _D % _Q


class JubjubAffine:
    __slots__ = ("u", "v")

    SIZE = 32

    def __init__(self, u: Fq, v: Fq):
        self.u, self.v = u, v

    @classmethod
    def identity(cls):
        return cls(Fq.zero(), Fq.one())

    @classmethod
    def generator(cls):
        return cls(Fq(params.JUBJUB_GENERATOR_X), Fq(params.JUBJUB_GENERATOR_Y))

    @classmethod
    def generator_nums(cls):
        return cls(Fq(params.JUBJUB_GENERATOR_NUMS_X), Fq(params.JUBJUB_GENERATOR_NUMS_Y))

    def is_identity(self) -> bool:
        return self.u.is_zero() and self.v.is_one()

    def is_on_curve(self) -> bool:
        u2, v2 = self.u.square(), self.v.square()
        return (v2 - u2 - Fq(_D) * u2 * v2).is_one()

    def __neg__(self):
        return JubjubAffine(-self.u, self.v)

    def __eq__(self, other):
        if isinstance(other, JubjubExtended):
            other = other.to_affine()
        return isinstance(other, JubjubAffine) and self.u == other.u and self.v == other.v

    def __hash__(self):
        return hash(("Jubjub", self.u.value, self.v.value))

    def __add__(self, other):
        return self.to_extended() + other

    def __mul__(self, scalar):
        return self.to_extended() * scalar

    __rmul__ = __mul__

    def to_extended(self) -> "JubjubExtended":
        return JubjubExtended(self.u, self.v, Fq.one(), self.u, self.v)

    # ---- encoding (lib.rs:561-642): v LE with sign-of-u in bit 255 -----------
    def to_bytes(self) -> bytes:
        buf = bytearray(self.v.to_bytes())
        buf[31] |= (self.u.value & 1) << 7
        return bytes(buf)

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) != 32:
            return None
        sign = (buf[31] >> 7) & 1
        body = bytes(buf[:31]) + bytes([buf[31] & 0x7F])
        v = Fq.from_bytes(body)
        if v is None:
            return None
        # u^2 = (v^2 - 1) / (d v^2 + 1)
        v2 = v.square()
        denom = (Fq(_D) * v2 + Fq.one()).invert()
        if denom is None:
            return None
        u2 = (v2 - Fq.one()) * denom
        u = u2.sqrt()
        if u is None:
            return None
        if (u.value & 1) != sign:
            u = -u
        if u.is_zero() and sign:
            return None  # -0 is non-canonical (coset.rs:97-101)
        return cls(u, v)

    def __repr__(self):
        return f"JubjubAffine(u=0x{self.u.value:x}, v=0x{self.v.value:x})"


class JubjubExtended:
    """Extended twisted Edwards coordinates (u, v, z, t1, t2), t = t1*t2 = uv/z."""

    __slots__ = ("u", "v", "z", "t1", "t2")

    def __init__(self, u: Fq, v: Fq, z: Fq, t1: Fq, t2: Fq):
        self.u, self.v, self.z, self.t1, self.t2 = u, v, z, t1, t2

    @classmethod
    def identity(cls):
        return cls(Fq.zero(), Fq.one(), Fq.one(), Fq.zero(), Fq.zero())

    @classmethod
    def generator(cls):
        return JubjubAffine.generator().to_extended()

    @classmethod
    def generator_nums(cls):
        return JubjubAffine.generator_nums().to_extended()

    @classmethod
    def from_affine(cls, a: JubjubAffine):
        return a.to_extended()

    def is_identity(self) -> bool:
        return self.u.is_zero() and (self.v == self.z)

    def double(self) -> "JubjubExtended":
        # dbl-2008-hwcd (a = -1), completed coordinates (U, V, Z, T)
        uu = self.u.square()
        vv = self.v.square()
        zz2 = self.z.square().double()
        uv2 = (self.u + self.v).square()
        vpu = vv + uu
        vmu = vv - uu
        return JubjubExtended._from_completed(uv2 - vpu, vpu, vmu, zz2 - vmu)

    @staticmethod
    def _from_completed(U: Fq, V: Fq, Z: Fq, T: Fq) -> "JubjubExtended":
        """Completed (U,V,Z,T) -> extended: u=UT, v=VZ, z=ZT, cached t1=U, t2=V."""
        return JubjubExtended(U * T, V * Z, Z * T, U, V)

    def __add__(self, other) -> "JubjubExtended":
        if isinstance(other, JubjubAffine):
            other = other.to_extended()
        # add-2008-hwcd-3 (a = -1), using cached t1,t2
        a = (self.v - self.u) * (other.v - other.u)
        b = (self.v + self.u) * (other.v + other.u)
        c = Fq(_D2) * self.t1 * self.t2 * other.t1 * other.t2
        d = self.z.double() * other.z
        return JubjubExtended._from_completed(b - a, b + a, d + c, d - c)

    def __neg__(self):
        return JubjubExtended(-self.u, self.v, self.z, -self.t1, self.t2)

    def __sub__(self, other):
        if isinstance(other, JubjubAffine):
            other = other.to_extended()
        return self + (-other)

    def __mul__(self, scalar) -> "JubjubExtended":
        if isinstance(scalar, JubjubFr):
            k = scalar.value
        elif isinstance(scalar, Fq):
            k = scalar.value
        else:
            k = int(scalar)
        acc = JubjubExtended.identity()
        base = self
        while k > 0:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __eq__(self, other):
        if isinstance(other, JubjubAffine):
            other = other.to_extended()
        # u1 z2 == u2 z1 and v1 z2 == v2 z1
        return (self.u * other.z == other.u * self.z) and (
            self.v * other.z == other.v * self.z)

    def __hash__(self):
        return hash(self.to_affine())

    def to_affine(self) -> JubjubAffine:
        zinv = self.z.invert()
        return JubjubAffine(self.u * zinv, self.v * zinv)

    @staticmethod
    def batch_normalize(points: list["JubjubExtended"]) -> list[JubjubAffine]:
        zs = [p.z for p in points]
        prefix, acc = [], Fq.one()
        for z in zs:
            prefix.append(acc)
            acc = acc * z
        inv = acc.invert()
        out = [None] * len(points)
        for i in range(len(points) - 1, -1, -1):
            zi = prefix[i] * inv
            inv = inv * zs[i]
            out[i] = JubjubAffine(points[i].u * zi, points[i].v * zi)
        return out

    def is_on_curve(self) -> bool:
        return self.to_affine().is_on_curve()

    def is_torsion_free(self) -> bool:
        return (self * (JubjubFr.MODULUS)).is_identity()

    def mul_by_cofactor(self) -> "JubjubExtended":
        return self.double().double().double()

    def to_hash_inputs(self) -> list[Fq]:
        """Affine coordinates as two field elements (coset.rs:229)."""
        a = self.to_affine()
        return [a.u, a.v]

    def __repr__(self):
        return f"JubjubExtended({self.to_affine()!r})"


# ---- Niels points (lib.rs:224-360) ------------------------------------------

class AffineNielsPoint:
    """Precomputed affine point (v+u, v-u, 2d*u*v) for mixed addition."""

    __slots__ = ("v_plus_u", "v_minus_u", "t2d")

    def __init__(self, p: JubjubAffine):
        self.v_plus_u = p.v + p.u
        self.v_minus_u = p.v - p.u
        self.t2d = p.u * p.v * Fq(_D2)

    def add_to(self, p: JubjubExtended) -> JubjubExtended:
        a = (p.v - p.u) * self.v_minus_u
        b = (p.v + p.u) * self.v_plus_u
        c = self.t2d * p.t1 * p.t2
        d = p.z.double()
        return JubjubExtended._from_completed(b - a, b + a, d + c, d - c)

    def multiply_bits(self, bits_msb_first) -> JubjubExtended:
        """Constant-pattern double-and-add over a bit iterator (lib.rs:262)."""
        acc = JubjubExtended.identity()
        for bit in bits_msb_first:
            acc = acc.double()
            if bit:
                acc = self.add_to(acc)
        return acc


class ExtendedNielsPoint(AffineNielsPoint):
    def __init__(self, p: JubjubExtended):
        self.v_plus_u = p.v + p.u
        self.v_minus_u = p.v - p.u
        self.t2d = p.t1 * p.t2 * Fq(_D2)
        self.z = p.z.double()

    def add_to(self, p: JubjubExtended) -> JubjubExtended:
        a = (p.v - p.u) * self.v_minus_u
        b = (p.v + p.u) * self.v_plus_u
        c = self.t2d * p.t1 * p.t2
        d = p.z * self.z
        return JubjubExtended._from_completed(b - a, b + a, d + c, d - c)


# ---- coset extensions (coset.rs:25-233) --------------------------------------

def dhke(secret: JubjubFr, public: JubjubExtended) -> JubjubAffine:
    """Diffie-Hellman: secret * public (coset.rs:25)."""
    return (public * secret).to_affine()


def hash_to_point(data: bytes) -> JubjubExtended:
    """Blake2b-based try-and-increment embedding (coset.rs hash_to_point)."""
    counter = 0
    while True:
        state = hashlib.blake2b(data + counter.to_bytes(8, "little"),
                                digest_size=32).digest()
        p = JubjubAffine.from_bytes(state)
        if p is not None:
            ext = p.to_extended().mul_by_cofactor()
            if not ext.is_identity():
                return ext
        counter += 1


def map_to_point(value: int) -> JubjubExtended:
    """Embed a u64 into the prime-order subgroup (coset.rs:202-230).

    The u64 replaces the low 8 bytes of the GENERATOR's v-coordinate;
    the v-coordinate is bumped by 2^64 until the bytes decode to a
    prime-order point.  Invertible via `unmap_from_point` (the low bytes
    are never touched by the bump)."""
    y = JubjubAffine.generator().v
    vbytes = bytearray(y.to_bytes())
    vbytes[:8] = int(value).to_bytes(8, "little")
    y = Fq.from_bytes(bytes(vbytes))
    adder = Fq(1 << 64)
    while True:
        p = JubjubAffine.from_bytes(y.to_bytes())
        if p is not None:
            ext = p.to_extended()
            if ext.is_torsion_free() and not ext.is_identity():
                return ext
        y = y + adder


def unmap_from_point(point: JubjubExtended) -> int:
    """Recover the u64 embedded by `map_to_point` (coset.rs:233-239)."""
    return int.from_bytes(point.to_affine().to_bytes()[:8], "little")


class ElgamalCipher:
    """ElGamal encryption over Jubjub (coset-jubjub/src/elgamal.rs:16-100).

    Homomorphic: ciphertexts add/subtract pointwise and scale by scalars.
    """

    __slots__ = ("gamma", "delta")

    SIZE = 64

    def __init__(self, gamma: JubjubExtended, delta: JubjubExtended):
        self.gamma = gamma
        self.delta = delta

    @classmethod
    def encrypt(cls, secret: JubjubFr, public: JubjubExtended,
                generator: JubjubExtended,
                message: JubjubExtended) -> "ElgamalCipher":
        return cls(generator * secret, message + public * secret)

    def decrypt(self, secret: JubjubFr) -> JubjubExtended:
        return self.delta - self.gamma * secret

    def to_bytes(self) -> bytes:
        return (self.gamma.to_affine().to_bytes()
                + self.delta.to_affine().to_bytes())

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) != 64:
            return None
        gamma = JubjubAffine.from_bytes(buf[:32])
        delta = JubjubAffine.from_bytes(buf[32:])
        if gamma is None or delta is None:
            return None
        return cls(gamma.to_extended(), delta.to_extended())

    def __eq__(self, other):
        return (isinstance(other, ElgamalCipher)
                and self.gamma == other.gamma and self.delta == other.delta)

    def __add__(self, other):
        return ElgamalCipher(self.gamma + other.gamma,
                             self.delta + other.delta)

    def __sub__(self, other):
        return ElgamalCipher(self.gamma - other.gamma,
                             self.delta - other.delta)

    def __mul__(self, scalar):
        return ElgamalCipher(self.gamma * scalar, self.delta * scalar)

    __rmul__ = __mul__
