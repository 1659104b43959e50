"""In-circuit Poseidon: GadgetPermutation + HashGadget.

Mirrors coset-poseidon/src/hades/permutation/gadget.rs (round constants of
round r+1 folded into round r's MDS add-gates; x^5 as 3 mul gates) and
coset-poseidon/src/hash/gadget.rs (SAFE sponge driven over witnesses).
"""

from __future__ import annotations

from ..fields import Fr
from ..params import (HADES_FULL_ROUNDS, HADES_PARTIAL_ROUNDS,
                      HADES_WIDTH as WIDTH)
from ..plonk.composer import Composer
from ..plonk.constraint_system import Constraint, Witness
from ..utils import metrics
from .poseidon_constants import MDS_MATRIX, ROUND_CONSTANTS
from .poseidon import Domain, io_pattern
from .safe import Sponge

_ROUNDS = HADES_FULL_ROUNDS + HADES_PARTIAL_ROUNDS


class GadgetPermutation:
    """SAFE driver executing Hades over circuit witnesses
    (hades/permutation/gadget.rs:39-106)."""

    WIDTH = WIDTH

    def __init__(self, composer: Composer):
        self.composer = composer

    # -- SAFE driver interface ---------------------------------------------------
    def permute(self, state: list[Witness]) -> list[Witness]:
        """One Hades permutation as gates: the span
        `prove/poseidon_gadget`, inside the prover's witness synthesis."""
        s = list(state)
        half = HADES_FULL_ROUNDS // 2
        with metrics.GLOBAL.span("prove/poseidon_gadget"):
            for r in range(half):
                self._full_round(r, s)
            for r in range(HADES_PARTIAL_ROUNDS):
                self._partial_round(half + r, s)
            for r in range(half):
                self._full_round(half + HADES_PARTIAL_ROUNDS + r, s)
        return s

    def tag(self, data: bytes) -> Witness:
        return self.composer.append_constant(Fr.hash_to_scalar(data))

    def add(self, state_w: Witness, input_w: Witness) -> Witness:
        """Sponge absorb-add; wire order mirrors gadget.rs `add(right, left)`:
        the input lands on wire a, the state element on wire b."""
        return self.composer.gate_add(
            Constraint().left(1).a(input_w).right(1).b(state_w))

    def zero(self) -> Witness:
        return Composer.ZERO

    # -- Hades rounds (round constants folded into the MDS gates) ----------------
    def _add_round_constants(self, round_index: int, state: list[Witness]):
        if round_index == 0:
            for i in range(WIDTH):
                state[i] = self.composer.gate_add(
                    Constraint().left(1).a(state[i])
                    .constant(Fr(ROUND_CONSTANTS[0][i])))

    def _quintic_s_box(self, w: Witness) -> Witness:
        c = self.composer
        v2 = c.gate_mul(Constraint().mult(1).a(w).b(w))
        v4 = c.gate_mul(Constraint().mult(1).a(v2).b(v2))
        return c.gate_mul(Constraint().mult(1).a(v4).b(w))

    def _apply_mds(self, round_index: int, state: list[Witness]):
        result = []
        for j in range(WIDTH):
            c = (Fr(ROUND_CONSTANTS[round_index + 1][j])
                 if round_index + 1 < _ROUNDS else Fr.zero())
            first = self.composer.gate_add(
                Constraint()
                .left(Fr(MDS_MATRIX[j][0])).a(state[0])
                .right(Fr(MDS_MATRIX[j][1])).b(state[1])
                .fourth(Fr(MDS_MATRIX[j][2])).d(state[2]))
            second = self.composer.gate_add(
                Constraint()
                .left(Fr(MDS_MATRIX[j][3])).a(state[3])
                .right(Fr(MDS_MATRIX[j][4])).b(state[4])
                .fourth(1).d(first).constant(c))
            result.append(second)
        state[:] = result

    def _full_round(self, round_index: int, state: list[Witness]):
        self._add_round_constants(round_index, state)
        for i in range(WIDTH):
            state[i] = self._quintic_s_box(state[i])
        self._apply_mds(round_index, state)

    def _partial_round(self, round_index: int, state: list[Witness]):
        self._add_round_constants(round_index, state)
        state[WIDTH - 1] = self._quintic_s_box(state[WIDTH - 1])
        self._apply_mds(round_index, state)

    # -- dusk-safe Encryption extension (gadget.rs:79-96) -------------------------
    def subtract(self, minuend: Witness, subtrahend: Witness) -> Witness:
        return self.composer.gate_add(
            Constraint().left(1).a(minuend).right(-Fr.one()).b(subtrahend))

    def is_equal(self, lhs: Witness, rhs: Witness) -> bool:
        self.composer.assert_equal(lhs, rhs)
        return True


class HashGadget:
    """In-circuit Poseidon hash context (hash/gadget.rs:13-99)."""

    def __init__(self, domain: Domain):
        self.domain = domain
        self.input: list[list[Witness]] = []
        self._output_len = 1

    def output_len(self, n: int):
        if self.domain == Domain.Other and n > 0:
            self._output_len = n

    def update(self, witnesses):
        self.input.append(list(witnesses))

    def finalize(self, composer: Composer) -> list[Witness]:
        sponge = Sponge.start(
            GadgetPermutation(composer),
            io_pattern(self.domain, self.input, self._output_len),
            self.domain.value)
        for seg in self.input:
            sponge.absorb(len(seg), seg)
        sponge.squeeze(self._output_len)
        return sponge.finish()

    def finalize_truncated(self, composer: Composer) -> list[Witness]:
        return [composer.append_logic_xor(w, Composer.ZERO, 125)
                for w in self.finalize(composer)]

    @staticmethod
    def digest(composer: Composer, domain: Domain, witnesses) -> list[Witness]:
        g = HashGadget(domain)
        g.update(witnesses)
        return g.finalize(composer)

    @staticmethod
    def digest_truncated(composer: Composer, domain: Domain,
                         witnesses) -> list[Witness]:
        g = HashGadget(domain)
        g.update(witnesses)
        return g.finalize_truncated(composer)
