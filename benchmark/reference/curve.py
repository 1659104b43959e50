"""G1 of BLS12-381 in plain Python: y^2 = x^3 + 4 over F_p.

Points are affine pairs (x, y) or None for the identity; sums and products
run in Jacobian coordinates.  The 48-byte encoding is the compressed one
of the zcash / bls12_381 crates: big-endian x, with the compression,
infinity and sign flags in the three top bits of the first byte.
"""

from __future__ import annotations

from .field import P, R

GENERATOR = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)

_INF = (1, 1, 0)  # Jacobian identity


def _jac(pt):
    return _INF if pt is None else (pt[0], pt[1], 1)


def _double(a):
    x, y, z = a
    if z == 0 or y == 0:
        return _INF
    yy = y * y % P
    s = 4 * x * yy % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * yy * yy) % P
    return x3, y3, 2 * y * z % P


def _add(a, b):
    if a[2] == 0:
        return b
    if b[2] == 0:
        return a
    x1, y1, z1 = a
    x2, y2, z2 = b
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        return _double(a) if s1 == s2 else _INF
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    return x3, y3, z1 * z2 * h % P


def _affine(a):
    if a[2] == 0:
        return None
    zi = pow(a[2], -1, P)
    zi2 = zi * zi % P
    return a[0] * zi2 % P, a[1] * zi2 * zi % P


def _mul_jac(a, k: int):
    """k a by a 4-bit fixed window, MSB first (k >= 0)."""
    if k == 0 or a[2] == 0:
        return _INF
    table = [_INF, a]
    for _ in range(14):
        table.append(_add(table[-1], a))
    acc = _INF
    for shift in range((k.bit_length() + 3) // 4 * 4 - 4, -4, -4):
        for _ in range(4):
            acc = _double(acc)
        acc = _add(acc, table[(k >> shift) & 15])
    return acc


def add(a, b):
    return _affine(_add(_jac(a), _jac(b)))


def neg(a):
    return None if a is None else (a[0], (-a[1]) % P)


def mul(a, k: int):
    """[k] a for a scalar k (reduced mod r)."""
    return _affine(_mul_jac(_jac(a), k % R))


def lincomb(points, scalars):
    """sum_i [k_i] p_i, one affine result."""
    acc = _INF
    for pt, k in zip(points, scalars):
        acc = _add(acc, _mul_jac(_jac(pt), k % R))
    return _affine(acc)


def to_bytes(a) -> bytes:
    """The compressed encoding."""
    if a is None:
        return bytes([0xC0]) + bytes(47)
    buf = bytearray(a[0].to_bytes(48, "big"))
    buf[0] |= 0x80
    if a[1] > (P - 1) // 2:
        buf[0] |= 0x20
    return bytes(buf)


def from_bytes(buf: bytes):
    """Decode a compressed point; raises ValueError unless it is a point
    of the order-r subgroup (the identity decodes to None)."""
    if len(buf) != 48 or not buf[0] & 0x80:
        raise ValueError("not a compressed G1 encoding")
    infinity, sign = buf[0] & 0x40, buf[0] & 0x20
    body = bytes([buf[0] & 0x1F]) + bytes(buf[1:])
    x = int.from_bytes(body, "big")
    if infinity:
        if sign or x:
            raise ValueError("bad identity encoding")
        return None
    if x >= P:
        raise ValueError("x not below p")
    y2 = (x * x * x + 4) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("x is not on the curve")
    if (y > (P - 1) // 2) != bool(sign):
        y = P - y
    pt = (x, y)
    if _mul_jac(_jac(pt), R)[2] != 0:
        raise ValueError("point outside the order-r subgroup")
    return pt
