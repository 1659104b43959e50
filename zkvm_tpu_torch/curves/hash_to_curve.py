"""RFC 9380 hash-to-curve for G1: BLS12381G1_XMD:SHA-256_SSWU_{RO,NU}_.

Mirrors the reference's `experimental` feature
(coset-bls12_381/src/hash_to_curve/: ExpandMsgXmd expand_msg.rs:110, SSWU
map_g1.rs, 11-isogeny chain) -- expand_message_xmd over SHA-256,
hash_to_field with L=64, the simplified SWU map to the isogenous curve
E': y^2 = x^3 + A'x + B', the 11-degree isogeny to E, and cofactor clearing.
Off the proving hot path; host-side, variable time.

Pinned by the RFC 9380 test vectors committed in the reference test module
(tests/test_hash_to_curve.py).
"""

from __future__ import annotations

import hashlib

from .. import params
from ..fields import Fp
from .g1 import G1Affine, G1Projective
from .h2c_constants import (ISO11_XDEN, ISO11_XNUM, ISO11_YDEN, ISO11_YNUM,
                            SSWU_ELLP_A, SSWU_ELLP_B, SSWU_XI)

_P = Fp.MODULUS


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1, H = SHA-256."""
    h = hashlib.sha256
    b_in_bytes = 32
    r_in_bytes = 64
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    if len(dst) > 255:
        dst = h(b"H2C-OVERSIZE-DST-" + dst).digest()
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = bytes(r_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = h(b0 + b"\x01" + dst_prime).digest()
    out = bytearray(b1)
    bi = b1
    for i in range(2, ell + 1):
        bi = h(bytes(x ^ y for x, y in zip(b0, bi))
               + i.to_bytes(1, "big") + dst_prime).digest()
        out += bi
    return bytes(out[:len_in_bytes])


def expand_message_xof(msg: bytes, dst: bytes, len_in_bytes: int,
                       xof=None) -> bytes:
    """RFC 9380 section 5.3.2, H = SHAKE-128 by default (the reference's
    ExpandMsgXof, coset-bls12_381/src/hash_to_curve/expand_msg.rs:110).

    Pinned by the RFC 9380 K.6 expand_message_xof test vectors
    (tests/test_hash_to_curve.py)."""
    h = xof or hashlib.shake_128
    if len(dst) > 255:
        reader = h(b"H2C-OVERSIZE-DST-" + dst)
        dst = reader.digest(32)
    dst_prime = dst + len(dst).to_bytes(1, "big")
    msg_prime = msg + len_in_bytes.to_bytes(2, "big") + dst_prime
    return h(msg_prime).digest(len_in_bytes)


def hash_to_field(msg: bytes, dst: bytes, count: int) -> list[Fp]:
    """RFC 9380 section 5.2 (m=1, L=64)."""
    length = 64
    uniform = expand_message_xmd(msg, dst, count * length)
    return [Fp(int.from_bytes(uniform[i * length:(i + 1) * length], "big"))
            for i in range(count)]


def _sgn0(x: int) -> int:
    return x & 1


def _map_to_curve_sswu(u: Fp) -> tuple[int, int]:
    """Simplified SWU onto the isogenous curve E' (RFC 9380 section 6.6.2)."""
    a, b, z = SSWU_ELLP_A, SSWU_ELLP_B, SSWU_XI
    uu = u.value
    tv1 = z * uu % _P * uu % _P           # Z u^2
    tv2 = tv1 * tv1 % _P                  # Z^2 u^4
    denom = (tv2 + tv1) % _P
    if denom == 0:
        x1 = b * pow(z * a % _P, -1, _P) % _P
    else:
        x1 = (-b % _P) * pow(a, -1, _P) % _P * (1 + pow(denom, -1, _P)) % _P
    gx1 = (pow(x1, 3, _P) + a * x1 + b) % _P
    e = pow(gx1, (_P - 1) >> 1, _P)
    if e in (0, 1):
        x, y2 = x1, gx1
    else:
        x = tv1 * x1 % _P
        y2 = gx1 * tv1 % _P * tv1 % _P * tv1 % _P  # g(x2) = Z^3 u^6 g(x1)
    y = pow(y2, (_P + 1) >> 2, _P)
    assert y * y % _P == y2, "not square"
    if _sgn0(uu) != _sgn0(y):
        y = _P - y
    return x, y


def _iso11(x: int, y: int) -> G1Projective:
    """Apply the 11-degree isogeny E' -> E (map_g1.rs iso_map)."""
    def horner(coeffs: list[int], v: int) -> int:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * v + c) % _P
        return acc

    xnum = horner(ISO11_XNUM, x)
    xden = horner(ISO11_XDEN, x)
    ynum = horner(ISO11_YNUM, x)
    yden = horner(ISO11_YDEN, x)
    # projective: (xnum*yden : y*ynum*xden : xden*yden)
    zz = xden * yden % _P
    return G1Projective(Fp(xnum * yden % _P), Fp(y * ynum % _P * xden % _P),
                        Fp(zz))


def map_to_curve_g1(u: Fp) -> G1Projective:
    x, y = _map_to_curve_sswu(u)
    return _iso11(x, y)


def hash_to_curve_g1(msg: bytes, dst: bytes) -> G1Projective:
    """Random-oracle encoding (two field elements, add, clear cofactor)."""
    u0, u1 = hash_to_field(msg, dst, 2)
    q = map_to_curve_g1(u0) + map_to_curve_g1(u1)
    return q.clear_cofactor()


def encode_to_curve_g1(msg: bytes, dst: bytes) -> G1Projective:
    """Nonuniform encoding (one field element)."""
    u0 = hash_to_field(msg, dst, 1)[0]
    return map_to_curve_g1(u0).clear_cofactor()


def hash_to_scalar_field(msg: bytes, dst: bytes, count: int = 1):
    """hash_to_field into Fr (map_scalar.rs equivalent, L=48)."""
    from ..fields import Fr

    length = 48
    uniform = expand_message_xmd(msg, dst, count * length)
    return [Fr(int.from_bytes(uniform[i * length:(i + 1) * length], "big"))
            for i in range(count)]


# =============================================================================
# G2: BLS12381G2_XMD:SHA-256_SSWU_{RO,NU}_ (hash_to_curve/map_g2.rs)
# =============================================================================

def hash_to_field_fp2(msg: bytes, dst: bytes, count: int):
    """RFC 9380 section 5.2 with m=2, L=64 (128 bytes per Fp2 element)."""
    from ..fields import Fp2

    length = 128
    uniform = expand_message_xmd(msg, dst, count * length)
    out = []
    for i in range(count):
        chunk = uniform[i * length:(i + 1) * length]
        c0 = Fp(int.from_bytes(chunk[:64], "big"))
        c1 = Fp(int.from_bytes(chunk[64:], "big"))
        out.append(Fp2(c0, c1))
    return out


def _sgn0_fp2(x) -> int:
    s0 = x.c0.value & 1
    z0 = x.c0.value == 0
    s1 = x.c1.value & 1
    return s0 | (int(z0) & s1)


def _map_to_curve_sswu_g2(u):
    """Simplified SWU onto the 3-isogenous curve over Fp2."""
    from ..fields import Fp2
    from .h2c_g2_constants import SSWU_ELLP_A, SSWU_ELLP_B, SSWU_XI

    a = Fp2(Fp(SSWU_ELLP_A[0]), Fp(SSWU_ELLP_A[1]))
    b = Fp2(Fp(SSWU_ELLP_B[0]), Fp(SSWU_ELLP_B[1]))
    z = Fp2(Fp(SSWU_XI[0]), Fp(SSWU_XI[1]))

    tv1 = z * u.square()          # Z u^2
    tv2 = tv1.square()
    denom = tv2 + tv1
    if denom.is_zero():
        x1 = b * (z * a).invert()
    else:
        x1 = (-b) * a.invert() * (Fp2.one() + denom.invert())
    gx1 = x1.square() * x1 + a * x1 + b
    y = gx1.sqrt()
    if y is not None:
        x = x1
    else:
        x = tv1 * x1
        gx2 = gx1 * tv1.square() * tv1   # g(x2) = Z^3 u^6 g(x1)
        y = gx2.sqrt()
        assert y is not None, "SSWU: neither branch square"
    if _sgn0_fp2(u) != _sgn0_fp2(y):
        y = -y
    return x, y


def _iso3(x, y):
    """3-degree isogeny E' -> E over Fp2 (map_g2.rs iso_map)."""
    from ..fields import Fp2
    from .g2 import G2Projective
    from .h2c_g2_constants import (ISO3_XDEN, ISO3_XNUM, ISO3_YDEN,
                                   ISO3_YNUM)

    def horner(coeffs, v):
        acc = Fp2.zero()
        for c0, c1 in reversed(coeffs):
            acc = acc * v + Fp2(Fp(c0), Fp(c1))
        return acc

    xnum = horner(ISO3_XNUM, x)
    xden = horner(ISO3_XDEN, x)
    ynum = horner(ISO3_YNUM, x)
    yden = horner(ISO3_YDEN, x)
    return G2Projective(xnum * yden, y * ynum * xden, xden * yden)


def map_to_curve_g2(u):
    x, y = _map_to_curve_sswu_g2(u)
    return _iso3(x, y)


def hash_to_curve_g2(msg: bytes, dst: bytes):
    """Random-oracle G2 encoding (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_)."""
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    q = map_to_curve_g2(u0) + map_to_curve_g2(u1)
    return q.clear_cofactor()


def encode_to_curve_g2(msg: bytes, dst: bytes):
    """Nonuniform G2 encoding."""
    u0 = hash_to_field_fp2(msg, dst, 1)[0]
    return map_to_curve_g2(u0).clear_cofactor()
