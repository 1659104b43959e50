"""Jubjub scalar field (252-bit). Reference parity: coset-jubjub/src/fr.rs."""

from __future__ import annotations

from .. import params
from .field import PrimeField


class JubjubFr(PrimeField):
    __slots__ = ()

    MODULUS = params.JUBJUB_FR_MODULUS
    NUM_BYTES = 32
    R = params.JUBJUB_FR_R
    R2 = params.JUBJUB_FR_R2
    TWO_ADICITY = params.JUBJUB_FR_TWO_ADICITY

    def compute_windowed_naf(self, width: int):
        """Signed width-w NAF digits, LSB first, 256 entries.

        Mirrors coset-jubjub/src/fr/coset.rs:90 (`compute_windowed_naf`):
        produces digits in (-2^(w-1), 2^(w-1)] with at most one nonzero per
        w-1 consecutive positions... the reference emits one digit per bit
        position (zeros between nonzero digits).
        """
        k = self.value
        out = [0] * 256
        i = 0
        while k >= 1:
            if k & 1:
                mod = k & ((1 << width) - 1)  # k mod 2^width
                if mod >= (1 << (width - 1)):  # mods_2_pow_k: >= 2^(w-1) wraps negative
                    mod -= 1 << width
                out[i] = mod
                k -= mod
            k >>= 1
            i += 1
        return out
