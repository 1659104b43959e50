"""SAFE sponge (Sponge API for Field Elements).

Reconstructed from the SAFE specification as used by the unvendored
`dusk-safe 0.3` crate the reference depends on (coset-poseidon uses
`coset_safe::{Sponge, Call, Safe}`).  The absorb/squeeze/permute mechanics
are pinned bit-exactly by the reference golden digests
(coset-poseidon/src/hades.rs:106-142, reproduced in tests/test_poseidon.py).

State layout for width W: 1 capacity element at index 0 (initialized with the
domain tag), rate = W - 1 elements at indexes 1..W.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class IOPatternViolation(ValueError):
    pass


class CallKind(Enum):
    ABSORB = 0
    SQUEEZE = 1


@dataclass(frozen=True)
class Call:
    kind: CallKind
    len: int

    @staticmethod
    def absorb(n: int) -> "Call":
        return Call(CallKind.ABSORB, n)

    @staticmethod
    def squeeze(n: int) -> "Call":
        return Call(CallKind.SQUEEZE, n)


def aggregate_io_pattern(io: list[Call]) -> list[Call]:
    """Merge adjacent same-kind calls (SAFE io-pattern normalization)."""
    out: list[Call] = []
    for call in io:
        if call.len == 0:
            raise IOPatternViolation("zero-length call")
        if out and out[-1].kind == call.kind:
            out[-1] = Call(call.kind, out[-1].len + call.len)
        else:
            out.append(call)
    if not out or out[0].kind != CallKind.ABSORB or out[-1].kind != CallKind.SQUEEZE:
        raise IOPatternViolation("pattern must start with absorb and end with squeeze")
    return out


def tag_input(io: list[Call], domain_sep: int) -> bytes:
    """Serialize the aggregated io-pattern + domain separator for the tag hash.

    Each call is one big-endian u32 word: absorb(n) = 0x8000_0000 + n,
    squeeze(n) = n; the u64 domain separator is appended big-endian.
    (Observable only through cross-stack hash equality; the golden digests use
    a zero tag and pin the sponge mechanics independent of this encoding.)
    """
    buf = bytearray()
    for call in io:
        word = (0x8000_0000 + call.len) if call.kind == CallKind.ABSORB else call.len
        buf += word.to_bytes(4, "big")
    buf += int(domain_sep).to_bytes(8, "big")
    return bytes(buf)


class Sponge:
    """Duplex sponge over a SAFE permutation backend.

    The backend supplies `permute(state)->state`, `tag(bytes)->T`,
    `add(T,T)->T`, `zero()->T`, and `WIDTH`.
    """

    def __init__(self, safe, iopattern: list[Call], domain_sep: int = 0):
        self.safe = safe
        self.io = aggregate_io_pattern(list(iopattern))
        self.width = safe.WIDTH
        self.rate = self.width - 1
        tag = safe.tag(tag_input(self.io, domain_sep))
        self.state = [safe.zero() for _ in range(self.width)]
        self.state[0] = tag
        self.pos_absorb = 0   # next rate slot to absorb into
        self.pos_squeeze = self.rate  # force a permute before the first squeeze
        self.io_cursor = 0    # index into aggregated io pattern
        self.io_remaining = self.io[0].len
        self.output: list = []
        self.finished = False

    @classmethod
    def start(cls, safe, iopattern: list[Call], domain_sep: int = 0) -> "Sponge":
        return cls(safe, iopattern, domain_sep)

    def _advance_io(self, kind: CallKind, n: int):
        if self.finished:
            raise IOPatternViolation("sponge already finished")
        while n > 0:
            if self.io_cursor >= len(self.io):
                raise IOPatternViolation("io pattern exhausted")
            cur = self.io[self.io_cursor]
            if cur.kind != kind:
                raise IOPatternViolation(f"expected {cur.kind}, got {kind}")
            take = min(n, self.io_remaining)
            self.io_remaining -= take
            n -= take
            if self.io_remaining == 0:
                self.io_cursor += 1
                if self.io_cursor < len(self.io):
                    self.io_remaining = self.io[self.io_cursor].len
            elif n > 0:
                raise IOPatternViolation("call spans io boundary")

    def absorb(self, length: int, elements) -> None:
        self._advance_io(CallKind.ABSORB, length)
        for x in list(elements)[:length]:
            if self.pos_absorb == self.rate:
                self.state = self.safe.permute(self.state)
                self.pos_absorb = 0
            self.state[self.pos_absorb + 1] = self.safe.add(
                self.state[self.pos_absorb + 1], x)
            self.pos_absorb += 1
        self.pos_squeeze = self.rate  # next squeeze must permute first

    def squeeze(self, length: int) -> list:
        self._advance_io(CallKind.SQUEEZE, length)
        out = []
        for _ in range(length):
            if self.pos_squeeze == self.rate:
                self.state = self.safe.permute(self.state)
                self.pos_squeeze = 0
                self.pos_absorb = 0
            out.append(self.state[self.pos_squeeze + 1])
            self.pos_squeeze += 1
        self.output.extend(out)
        return out

    def finish(self) -> list:
        if self.io_cursor < len(self.io):
            raise IOPatternViolation("io pattern not complete")
        self.finished = True
        return list(self.output)
