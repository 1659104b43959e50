"""KZG10 commitments worked out with the trapdoor: commit(p) = [p(tau)] g.

The coefficients arrive as the program's inputs are made: [8, L] arrays
of 32-bit Montgomery words, limb 0 least significant, the word m standing
for the scalar m R^-1 mod r (R = 2^256).  By linearity p(tau) =
R^-1 sum_i m_i tau^i, so the words are summed as they are.
"""

from __future__ import annotations

import numpy as np

from . import curve
from .field import MONT_R_INV, R


def words_to_ints(limbs: np.ndarray) -> list[int]:
    """[8, L] 32-bit limbs (any integer dtype) -> L Python ints."""
    raw = np.ascontiguousarray(limbs.astype(np.uint32).T).tobytes()
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little")
            for i in range(limbs.shape[1])]


def evaluate_mont(limbs: np.ndarray, tau: int, drop_top_limb=False) -> int:
    """p(tau) for the polynomial whose Montgomery coefficient words are
    `limbs`.  `drop_top_limb` zeroes each word's top 32 bits first: the
    control, a commitment to 224-bit scalars."""
    if drop_top_limb:
        limbs = limbs.copy()
        limbs[-1] = 0
    acc = 0
    for m in reversed(words_to_ints(limbs)):
        acc = (acc * tau + m) % R
    return acc * MONT_R_INV % R


def commitment(limbs: np.ndarray, tau: int, g, drop_top_limb=False) -> bytes:
    """The compressed encoding of [p(tau)] g."""
    return curve.to_bytes(curve.mul(g, evaluate_mont(limbs, tau,
                                                     drop_top_limb)))
