"""Complete projective short-Weierstrass group law (a = 0), field-generic.

Renes-Costello-Batina 2015 complete formulas: branch-free, identity- and
doubling-safe -- the same algebra the batched device kernels use
(zkvm_tpu/ops/g1_ops.py), expressed here over host field elements so G1 (Fp)
and G2 (Fp2) share one implementation.

Reference parity: coset-bls12_381/src/g1.rs:425-782, g2.rs (add/double/mul).
"""

from __future__ import annotations


def proj_add(F, b3, X1, Y1, Z1, X2, Y2, Z2):
    """Complete addition, algorithm 7 of RCB15 (a=0); b3 = 3*b as field elt."""
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2) - t0 - t1
    t4 = (Y1 + Z1) * (Y2 + Z2) - t1 - t2
    t5 = (X1 + Z1) * (X2 + Z2) - t0 - t2
    t6 = b3 * t2
    z3 = t1 + t6
    t1 = t1 - t6
    y3 = b3 * t5
    x3 = t4 * y3
    x3 = t3 * t1 - x3
    y3 = y3 * (t0 + t0 + t0)
    y3 = t1 * z3 + y3
    t0 = (t0 + t0 + t0) * t3
    z3 = z3 * t4 + t0
    return x3, y3, z3


def proj_double(F, b3, X, Y, Z):
    """Complete doubling, algorithm 9 of RCB15 (a=0)."""
    t0 = Y * Y
    z3 = t0 + t0
    z3 = z3 + z3
    z3 = z3 + z3
    t1 = Y * Z
    t2 = Z * Z
    t2 = b3 * t2
    x3 = t2 * z3
    y3 = t0 + t2
    z3 = t1 * z3
    t1 = t2 + t2
    t2 = t1 + t2
    t0 = t0 - t2
    y3 = t0 * y3 + x3
    x3 = (X * Y) * t0
    x3 = x3 + x3
    return x3, y3, z3


def proj_mul(F, b3, X, Y, Z, scalar: int, identity):
    """Double-and-add scalar multiplication (host-side, variable time)."""
    rx, ry, rz = identity
    ax, ay, az = X, Y, Z
    while scalar > 0:
        if scalar & 1:
            rx, ry, rz = proj_add(F, b3, rx, ry, rz, ax, ay, az)
        scalar >>= 1
        if scalar:
            ax, ay, az = proj_double(F, b3, ax, ay, az)
    return rx, ry, rz
