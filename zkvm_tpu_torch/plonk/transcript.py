"""Fiat-Shamir transcript: merlin 3.0.0 (STROBE-128 / Keccak-f[1600]) rebuilt.

The reference drives its transcript through the external `merlin` crate
(plonk/src/transcript.rs:9,30-65).  Challenges must match byte-for-byte for
proofs to be cross-verifiable, so this module reimplements merlin's exact
STROBE-128 construction from the public STROBE v1.0.2 spec, pinned by
merlin's own published known-answer test (see tests/test_transcript.py).

The transcript is inherently serial and tiny -- it stays on the host; device
code only ever sees the broadcast challenge scalars.
"""

from __future__ import annotations

from ..fields import Fr

# ---------------------------------------------------------------------------
# Keccak-f[1600]
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] over a 200-byte state (little-endian lanes).

    Prefers the native permutation (native/bls.c, same byte semantics,
    KAT-pinned by tests/test_transcript.py either way); this pure-Python
    version is the fallback."""
    from ..native import native_keccak_f1600

    if native_keccak_f1600(state):
        return
    a = [[int.from_bytes(state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8], "little")
          for y in range(5)] for x in range(5)]
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & _MASK64) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8] = a[x][y].to_bytes(8, "little")


# ---------------------------------------------------------------------------
# STROBE-128 (exactly the subset merlin 3.0.0 implements in strobe.rs)
# ---------------------------------------------------------------------------

STROBE_R = 166  # 200 - 2*16 - 2 (security 128)

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals ------------------------------------------------------------
    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "ops must be continued with the same flags"
            return
        assert flags & FLAG_T == 0, "T flag not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops (merlin uses exactly these) --------------------------------
    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def _overwrite(self, data: bytes):
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c


# ---------------------------------------------------------------------------
# merlin::Transcript
# ---------------------------------------------------------------------------

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    """merlin 3.0.0 Transcript (lib.rs new/append_message/challenge_bytes)."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int):
        self.append_message(label, int(value).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)

    def clone(self) -> "Transcript":
        c = object.__new__(Transcript)
        c.strobe = self.strobe.clone()
        return c

    # -- PLONK TranscriptProtocol extensions (plonk/src/transcript.rs:30-65) --
    def append_commitment(self, label: bytes, commitment):
        self.append_message(label, commitment.to_bytes())

    def append_scalar(self, label: bytes, s: Fr):
        self.append_message(label, s.to_bytes())

    def challenge_scalar(self, label: bytes) -> Fr:
        return Fr.from_bytes_wide(self.challenge_bytes(label, 64))

    def circuit_domain_sep(self, n: int):
        self.append_message(b"dom-sep", b"circuit_size")
        self.append_u64(b"n", n)
