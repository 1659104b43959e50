"""rand 0.8's StdRng::seed_from_u64 (ChaCha12 keyed by a PCG32 expansion of
the seed), byte for byte: the stream the program's KZG setup draws tau
from.  A frozen copy of the port's generator, which the repository holds
against the reference crates.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


def chacha_block(key_words, counter: int, nonce_words, rounds: int) -> bytes:
    """One ChaCha block (djb variant: 64-bit counter in words 12-13)."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _M32, (counter >> 32) & _M32,
        *nonce_words,
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32; x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _M32; x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _M32; x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _M32; x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15)
        qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14)
    out = bytearray()
    for i in range(16):
        out += ((x[i] + state[i]) & _M32).to_bytes(4, "little")
    return bytes(out)


def seed_from_u64(state: int, n_bytes: int = 32) -> bytes:
    """rand_core 0.6 SeedableRng::seed_from_u64: PCG32 expansion."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    state &= _M64
    while len(out) < n_bytes:
        state = (state * MUL + INC) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & _M32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _M32
        out += x.to_bytes(4, "little")
    return bytes(out[:n_bytes])


class ChaChaRng:
    """rand_chacha-compatible keystream RNG (sequential 64-byte blocks)."""

    def __init__(self, seed: bytes, rounds: int):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[4 * i: 4 * i + 4], "little") for i in range(8)]
        self.rounds = rounds
        self.counter = 0
        self.buf = b""

    @classmethod
    def seed_from_u64(cls, seed: int, rounds: int = 12) -> "ChaChaRng":
        return cls(seed_from_u64(seed), rounds)

    def _refill(self):
        self.buf += chacha_block(self.key, self.counter, (0, 0), self.rounds)
        self.counter += 1

    def randbytes(self, n: int) -> bytes:
        while len(self.buf) < n:
            self._refill()
        out, self.buf = self.buf[:n], self.buf[n:]
        return out



def StdRng(seed: int) -> ChaChaRng:
    """rand 0.8 StdRng::seed_from_u64(seed) (= ChaCha12)."""
    return ChaChaRng.seed_from_u64(seed, rounds=12)
