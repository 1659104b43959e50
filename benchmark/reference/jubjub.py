"""JubJub in plain integers: the twisted Edwards curve -x^2 + y^2 = 1 +
d x^2 y^2 over F_r, r the BLS12-381 scalar field (a = -1, d = -10240 /
10241), the embedded curve of the circuits' curve gadgets.

Points are affine pairs (x, y); the identity is (0, 1).  The addition law
is complete on this curve (d is not a square), so it has no cases.  The
generators are frozen copies of dusk-jubjub's `GENERATOR` and
`GENERATOR_NUMS`.
"""

from __future__ import annotations

from .field import R

D = -10240 * pow(10241, -1, R) % R
# the order of the prime subgroup the generators span (JubJub's scalar field)
ORDER = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7

IDENTITY = (0, 1)
GENERATOR = (
    0x3FD2814C43AC65A6F1FBF02D0FD6CCE62E3EBB21FD6C54ED4DF7B7FFEC7BEACA,
    0x0000000000000000000000000000000000000000000000000000000000000012)
GENERATOR_NUMS = (
    0x5E67B8F316F414F7BD9514C773FD4456931E316A39FE4541921710179DF76377,
    0x43D80EB3B2F3EB1B7B162DBEEB3B34FD9949BA0F82A5507A6705B707162E3EF8)


def on_curve(p) -> bool:
    x2, y2 = p[0] * p[0] % R, p[1] * p[1] % R
    return (y2 - x2 - 1 - D * x2 % R * y2) % R == 0


def add(p, q):
    """p + q: x3 = (x1 y2 + y1 x2) / (1 + t), y3 = (y1 y2 + x1 x2) /
    (1 - t), t = d x1 x2 y1 y2."""
    (x1, y1), (x2, y2) = p, q
    t = D * x1 % R * x2 % R * y1 % R * y2 % R
    x3 = (x1 * y2 + y1 * x2) * pow(1 + t, -1, R) % R
    y3 = (y1 * y2 + x1 * x2) * pow(1 - t, -1, R) % R
    return x3, y3


def neg(p):
    return -p[0] % R, p[1]


def double(p):
    return add(p, p)


def mul(p, k: int):
    """[k] p by double-and-add, most significant bit first (k >= 0)."""
    acc = IDENTITY
    for bit in bin(k)[2:] if k else "":
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc
