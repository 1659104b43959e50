"""The KZG setup's secrets, drawn again from the seed.

`PublicParameters::setup(max_degree, rng)` (kzg10/srs.rs) draws, in this
order, tau, then the scalar s of the base point g = [s] G1, then the G2
point's scalar; the commit key is [tau^i] g.  Whoever knows tau checks a
pairing equation e(A, [tau] h) e(B, h) = 1 as [tau] A + B = 0 in G1, and
commits to p as [p(tau)] g.
"""

from __future__ import annotations

from . import curve
from .field import random_scalar
from .rng import StdRng


def trapdoor(seed: int):
    """(tau, g) of the setup driven by StdRng(seed)."""
    rng = StdRng(seed)
    tau = random_scalar(rng)
    g = curve.mul(curve.GENERATOR, random_scalar(rng))
    return tau, g
