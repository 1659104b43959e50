"""Hades permutation over the BLS12-381 scalar field (host reference).

Width 5, 4 full + 60 partial + 4 full rounds, quintic S-box, dense MDS mix.
Reference parity: coset-poseidon/src/hades/permutation.rs:11-67 and
permutation/scalar.rs:33-67.  The batched device version lives in
`ops/poseidon.py` (kernel `csrc/hades.cu`) and is tested against this one.
"""

from __future__ import annotations

from ..fields import Fr
from ..params import HADES_FULL_ROUNDS, HADES_PARTIAL_ROUNDS, HADES_WIDTH as WIDTH
from .poseidon_constants import MDS_MATRIX, ROUND_CONSTANTS

_Q = Fr.MODULUS


def hades_permute(state: list[int]) -> list[int]:
    """Full 68-round Hades permutation on 5 canonical ints mod q."""
    assert len(state) == WIDTH
    s = list(state)
    half = HADES_FULL_ROUNDS // 2

    def full_round(r):
        nonlocal s
        t = [(x + ROUND_CONSTANTS[r][i]) % _Q for i, x in enumerate(s)]
        t = [pow(x, 5, _Q) for x in t]
        s = [sum(MDS_MATRIX[row][col] * t[col] for col in range(WIDTH)) % _Q
             for row in range(WIDTH)]

    def partial_round(r):
        nonlocal s
        t = [(x + ROUND_CONSTANTS[r][i]) % _Q for i, x in enumerate(s)]
        t[WIDTH - 1] = pow(t[WIDTH - 1], 5, _Q)
        s = [sum(MDS_MATRIX[row][col] * t[col] for col in range(WIDTH)) % _Q
             for row in range(WIDTH)]

    for r in range(half):
        full_round(r)
    for r in range(HADES_PARTIAL_ROUNDS):
        partial_round(half + r)
    for r in range(half):
        full_round(half + HADES_PARTIAL_ROUNDS + r)
    return s


class ScalarPermutation:
    """SAFE permutation backend executing Hades natively on Fr elements.

    Mirrors coset-poseidon/src/hades/permutation/scalar.rs: `permute`, `tag`
    (blake2b hash_to_scalar of the io-pattern encoding), `add`.
    """

    WIDTH = WIDTH

    def permute(self, state: list[Fr]) -> list[Fr]:
        return [Fr(v) for v in hades_permute([x.value for x in state])]

    def tag(self, data: bytes) -> Fr:
        return Fr.hash_to_scalar(data)

    def add(self, a: Fr, b: Fr) -> Fr:
        return a + b

    def zero(self) -> Fr:
        return Fr.zero()

    # dusk-safe Encryption extension (permutation/scalar.rs:70-82)
    def subtract(self, minuend: Fr, subtrahend: Fr) -> Fr:
        return minuend - subtrahend

    def is_equal(self, a: Fr, b: Fr) -> bool:
        return a == b
