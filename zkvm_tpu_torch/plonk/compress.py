"""Portable compressed circuit description (plonk/src/composer/compress.rs).

Dedup tables: a scalar dictionary seeded with {0, 1, -1} plus (optionally)
the legacy Hades constant chain and Cauchy MDS (compress/hades.rs:14-33 --
note the reference seeds with a Sha512-chain table of 67 rounds, distinct
from the 68-round asset constants), a selector-combination ("polynomial")
table, and the constraint list.  Container: msgpack-style packing deflated
with raw DEFLATE (miniz compress_to_vec equivalent).
"""

from __future__ import annotations

import functools
import hashlib
import zlib

from ..fields import Fr
from .composer import Composer
from .constraint_system import Constraint, Selector, Witness
from .errors import BlsScalarMalformed, InvalidCompressedCircuit

_Q = Fr.MODULUS


# -----------------------------------------------------------------------------
# msgpack-style primitives (subset used by the circuit container)
# -----------------------------------------------------------------------------

def _pack_uint(buf: bytearray, v: int) -> None:
    if v < 0x80:
        buf.append(v)
    elif v <= 0xFF:
        buf += b"\xcc" + v.to_bytes(1, "big")
    elif v <= 0xFFFF:
        buf += b"\xcd" + v.to_bytes(2, "big")
    elif v <= 0xFFFFFFFF:
        buf += b"\xce" + v.to_bytes(4, "big")
    else:
        buf += b"\xcf" + v.to_bytes(8, "big")


def _pack_bool(buf: bytearray, v: bool) -> None:
    buf.append(0xC3 if v else 0xC2)


def _pack_bin(buf: bytearray, data: bytes) -> None:
    n = len(data)
    if n <= 0xFF:
        buf += b"\xc4" + n.to_bytes(1, "big")
    elif n <= 0xFFFF:
        buf += b"\xc5" + n.to_bytes(2, "big")
    else:
        buf += b"\xc6" + n.to_bytes(4, "big")
    buf += data


def _pack_array_header(buf: bytearray, n: int) -> None:
    if n < 16:
        buf.append(0x90 | n)
    elif n <= 0xFFFF:
        buf += b"\xdc" + n.to_bytes(2, "big")
    else:
        buf += b"\xdd" + n.to_bytes(4, "big")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise InvalidCompressedCircuit("truncated")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def uint(self) -> int:
        tag = self._take(1)[0]
        if tag < 0x80:
            return tag
        if tag == 0xCC:
            return self._take(1)[0]
        if tag == 0xCD:
            return int.from_bytes(self._take(2), "big")
        if tag == 0xCE:
            return int.from_bytes(self._take(4), "big")
        if tag == 0xCF:
            return int.from_bytes(self._take(8), "big")
        raise InvalidCompressedCircuit(f"bad uint tag {tag:#x}")

    def boolean(self) -> bool:
        tag = self._take(1)[0]
        if tag == 0xC3:
            return True
        if tag == 0xC2:
            return False
        raise InvalidCompressedCircuit(f"bad bool tag {tag:#x}")

    def binary(self) -> bytes:
        tag = self._take(1)[0]
        if tag == 0xC4:
            n = self._take(1)[0]
        elif tag == 0xC5:
            n = int.from_bytes(self._take(2), "big")
        elif tag == 0xC6:
            n = int.from_bytes(self._take(4), "big")
        else:
            raise InvalidCompressedCircuit(f"bad bin tag {tag:#x}")
        return self._take(n)

    def array_len(self) -> int:
        tag = self._take(1)[0]
        if 0x90 <= tag <= 0x9F:
            return tag & 0x0F
        if tag == 0xDC:
            return int.from_bytes(self._take(2), "big")
        if tag == 0xDD:
            return int.from_bytes(self._take(4), "big")
        raise InvalidCompressedCircuit(f"bad array tag {tag:#x}")


# -----------------------------------------------------------------------------
# Dedup dictionary seeds (compress/hades.rs)
# -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _legacy_hades_constants() -> tuple[int, ...]:
    """Sha512 chain seeded with b"poseidon-for-plonk" (compress/hades.rs:14)."""
    rounds, width = 59 + 8, 5
    out = []
    previous = 1
    chain = b"poseidon-for-plonk"
    for _ in range(rounds * width):
        chain = hashlib.sha512(chain).digest()
        value = (int.from_bytes(chain, "little") + previous) % _Q
        out.append(value)
        previous = value
    return tuple(out)


@functools.lru_cache(maxsize=1)
def _legacy_hades_mds() -> tuple[int, ...]:
    """Cauchy matrix 1/(x_i + y_j), x=0..4, y=5..9 (compress/hades.rs:33)."""
    width = 5
    out = []
    for i in range(width):
        for j in range(width):
            out.append(pow(i + (j + width), -1, _Q))
    return tuple(out)


def _scalar_map(hades_optimization: bool) -> dict[int, int]:
    scalars = {0: 0, 1: 1, (_Q - 1): 2}
    if hades_optimization:
        for constant in _legacy_hades_constants():
            scalars.setdefault(constant, len(scalars))
        for entry in _legacy_hades_mds():
            scalars.setdefault(entry, len(scalars))
    return scalars


_SELECTOR_ORDER = (Selector.MULTIPLICATION, Selector.LEFT, Selector.RIGHT,
                   Selector.OUTPUT, Selector.FOURTH, Selector.CONSTANT,
                   Selector.ARITHMETIC, Selector.RANGE, Selector.LOGIC,
                   Selector.GROUP_ADD_FIXED_BASE,
                   Selector.GROUP_ADD_VARIABLE_BASE)

_GATE_FIELDS = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith",
                "q_range", "q_logic", "q_fixed_group_add",
                "q_variable_group_add")


class CompressedCircuit:
    """Pack/unpack a Composer's circuit description (compress.rs:15-343)."""

    @staticmethod
    def from_composer(hades_optimization: bool, composer: Composer) -> bytes:
        public_inputs = sorted(composer.public_inputs.keys())
        witnesses = len(composer.witnesses)
        scalars = _scalar_map(hades_optimization)
        base_len = len(scalars)
        polynomial_index_map: dict[tuple, int] = {}
        constraints = []
        for gate in composer.constraints:
            combo = []
            for name in _GATE_FIELDS:
                value = getattr(gate, name).value
                idx = scalars.setdefault(value, len(scalars))
                combo.append(idx)
            combo = tuple(combo)
            poly_idx = polynomial_index_map.setdefault(
                combo, len(polynomial_index_map))
            constraints.append((poly_idx, gate.a.index, gate.b.index,
                                gate.c.index, gate.d.index))
        # dictionary scalars beyond the seeded base, by first-use order
        inv = sorted(((idx, val) for val, idx in scalars.items()))
        extra_scalars = [val for idx, val in inv if idx >= base_len]
        polynomials = sorted(((idx, combo)
                              for combo, idx in polynomial_index_map.items()))

        buf = bytearray()
        _pack_bool(buf, hades_optimization)
        _pack_array_header(buf, len(public_inputs))
        for pi in public_inputs:
            _pack_uint(buf, pi)
        _pack_uint(buf, witnesses)
        _pack_array_header(buf, len(extra_scalars))
        for value in extra_scalars:
            _pack_bin(buf, Fr(value).to_bytes())
        _pack_array_header(buf, len(polynomials))
        for _, combo in polynomials:
            for idx in combo:
                _pack_uint(buf, idx)
        _pack_array_header(buf, len(constraints))
        for entry in constraints:
            for idx in entry:
                _pack_uint(buf, idx)
        return zlib.compress(bytes(buf), level=9)[2:-4]  # raw deflate

    @staticmethod
    def from_bytes(compressed: bytes) -> Composer:
        try:
            packed = zlib.decompress(compressed, wbits=-15)
        except zlib.error as err:
            raise InvalidCompressedCircuit(str(err)) from None
        r = _Reader(packed)
        hades_optimization = r.boolean()
        public_inputs = [r.uint() for _ in range(r.array_len())]
        witnesses = r.uint()
        scalar_seed = _scalar_map(hades_optimization)
        all_scalars = [0] * len(scalar_seed)
        for value, idx in scalar_seed.items():
            all_scalars[idx] = value
        for _ in range(r.array_len()):
            scalar = Fr.from_bytes(r.binary())
            if scalar is None:
                raise BlsScalarMalformed()
            all_scalars.append(scalar.value)
        polynomials = [tuple(r.uint() for _ in range(len(_GATE_FIELDS)))
                       for _ in range(r.array_len())]
        n_constraints = r.array_len()

        composer = Composer.uninitialized()
        for _ in range(witnesses):
            composer.append_witness(Fr.zero())
        pi_cursor = 0
        for constraint_index in range(n_constraints):
            poly_idx = r.uint()
            a, b, c, d = (r.uint() for _ in range(4))
            try:
                combo = polynomials[poly_idx]
                values = [all_scalars[i] for i in combo]
            except IndexError:
                raise InvalidCompressedCircuit("bad index") from None
            constraint = Constraint()
            for sel, val in zip(_SELECTOR_ORDER, values):
                constraint = constraint.set(sel, Fr(val))
            constraint = (constraint.a(Witness(a)).b(Witness(b))
                          .c(Witness(c)).d(Witness(d)))
            if (pi_cursor < len(public_inputs)
                    and public_inputs[pi_cursor] == constraint_index):
                pi_cursor += 1
                constraint = constraint.public(Fr.zero())
            composer.append_custom_gate(constraint)
        return composer
