"""Poseidon hash over the SAFE sponge (coset-poseidon/src/hash.rs parity)."""

from __future__ import annotations

from enum import Enum

from ..fields import Fr, JubjubFr
from .hades import ScalarPermutation
from .safe import Call, IOPatternViolation, Sponge

# 250-bit truncation mask used by finalize_truncated (hash.rs:124-129)
TRUNCATION_MASK = (1 << 250) - 1


class Domain(Enum):
    """Domain separation tags (hash.rs:26-39)."""

    Merkle4 = 0x0000_0000_0000_000F  # 2^4 - 1
    Merkle2 = 0x0000_0000_0000_0003  # 2^2 - 1
    Encryption = 0x0000_0001_0000_0000  # 2^32
    Other = 0x0000_0000_0000_0000


def io_pattern(domain: Domain, input_segments, output_len: int) -> list[Call]:
    """Build and validate the sponge IO pattern (hash.rs:42-67)."""
    total = sum(len(seg) for seg in input_segments)
    if domain == Domain.Merkle2 and (total != 2 or output_len != 1):
        raise IOPatternViolation("Merkle2 requires 2 inputs, 1 output")
    if domain == Domain.Merkle4 and (total != 4 or output_len != 1):
        raise IOPatternViolation("Merkle4 requires 4 inputs, 1 output")
    calls = [Call.absorb(len(seg)) for seg in input_segments]
    calls.append(Call.squeeze(output_len))
    return calls


class Hash:
    """Incremental Poseidon hash context (hash.rs:69-159)."""

    def __init__(self, domain: Domain):
        self.domain = domain
        self.input: list[list[Fr]] = []
        self._output_len = 1

    def output_len(self, n: int):
        if self.domain == Domain.Other and n > 0:
            self._output_len = n

    def update(self, elements):
        self.input.append(list(elements))

    def finalize(self) -> list[Fr]:
        sponge = Sponge.start(
            ScalarPermutation(),
            io_pattern(self.domain, self.input, self._output_len),
            self.domain.value,
        )
        for seg in self.input:
            sponge.absorb(len(seg), seg)
        sponge.squeeze(self._output_len)
        return sponge.finish()

    def finalize_truncated(self) -> list[JubjubFr]:
        return [JubjubFr(fe.value & TRUNCATION_MASK) for fe in self.finalize()]

    @staticmethod
    def digest(domain: Domain, elements) -> list[Fr]:
        h = Hash(domain)
        h.update(elements)
        return h.finalize()

    @staticmethod
    def digest_truncated(domain: Domain, elements) -> list[JubjubFr]:
        h = Hash(domain)
        h.update(elements)
        return h.finalize_truncated()
