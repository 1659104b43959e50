"""Poseidon over the Hades permutation (width 5; 4 full, 60 partial, 4 full
rounds) and the SAFE sponge's Merkle4 digest, in plain integers.

The sponge of a Merkle4 digest: the state starts as [tag, 0, 0, 0, 0]
with tag the hash of its IO pattern (absorb 4, squeeze 1) and domain
separator 2^4 - 1; the four inputs are added to the rate, one permutation
follows, and the digest is the first rate element.
"""

from __future__ import annotations

from .field import R, hash_to_scalar
from .poseidon_constants import MDS_MATRIX, ROUND_CONSTANTS

WIDTH = 5
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 60
MERKLE4_DOMAIN = 0xF


def io_tag_bytes(absorb: int, squeeze: int, domain_sep: int) -> bytes:
    """The SAFE tag input: one big-endian u32 a call (absorb n = 2^31 + n,
    squeeze n = n), then the u64 domain separator, big-endian."""
    return ((0x8000_0000 + absorb).to_bytes(4, "big")
            + squeeze.to_bytes(4, "big") + domain_sep.to_bytes(8, "big"))


MERKLE4_TAG = hash_to_scalar(io_tag_bytes(4, 1, MERKLE4_DOMAIN))


def permute(state: list[int]) -> list[int]:
    s = list(state)

    def mix(t):
        return [sum(MDS_MATRIX[row][col] * t[col] for col in range(WIDTH)) % R
                for row in range(WIDTH)]

    half = FULL_ROUNDS // 2
    for r in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        t = [(x + ROUND_CONSTANTS[r][i]) % R for i, x in enumerate(s)]
        if half <= r < half + PARTIAL_ROUNDS:
            t[-1] = pow(t[-1], 5, R)
        else:
            t = [pow(x, 5, R) for x in t]
        s = mix(t)
    return s


def merkle4(children: list[int]) -> int:
    """Hash::digest(Domain::Merkle4, children)[0]."""
    if len(children) != 4:
        raise ValueError("Merkle4 takes four inputs")
    state = [MERKLE4_TAG] + [c % R for c in children]
    return permute(state)[1]
