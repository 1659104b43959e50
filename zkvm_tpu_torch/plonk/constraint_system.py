"""Witness / Constraint / Gate model (plonk/src/composer/constraint_system/).

The 4-wire TurboPLONK gate has 12 selector slots (q_m, q_l, q_r, q_o, q_f,
q_c, PI and the 5 gate-family selectors) and wires a, b, c, d
(composer/gate.rs:6, constraint_system/constraint.rs:10-120).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from ..fields import Fr


class Selector(IntEnum):
    """Selector slots (constraint.rs Selector enum)."""

    MULTIPLICATION = 0x00
    LEFT = 0x01
    RIGHT = 0x02
    OUTPUT = 0x03
    FOURTH = 0x04
    CONSTANT = 0x05
    PUBLIC_INPUT = 0x06
    ARITHMETIC = 0x07
    RANGE = 0x08
    LOGIC = 0x09
    GROUP_ADD_FIXED_BASE = 0x0A
    GROUP_ADD_VARIABLE_BASE = 0x0B


class WiredWitness(IntEnum):
    A = 0
    B = 1
    C = 2
    D = 3


class Witness:
    """Index into the composer's witness table (witness.rs:9).

    A hand-rolled frozen value class: the frozen-dataclass __init__ and
    tuple-hash cost dominated witness-synthesis dict operations at the
    2^16-gate flagship scale."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        object.__setattr__(self, "index", index)

    def __setattr__(self, *_):
        raise AttributeError("Witness is immutable")

    def __int__(self):
        return self.index

    def __eq__(self, other):
        return isinstance(other, Witness) and self.index == other.index

    def __hash__(self):
        return self.index

    def __repr__(self):
        return f"Witness(index={self.index})"


ZERO = Witness(0)
ONE = Witness(1)


@dataclass(frozen=True)
class WitnessPoint:
    """A Jubjub point as two witnesses (ecc.rs WitnessPoint)."""

    x: Witness
    y: Witness


class WireData:
    """Tagged wire-usage record (witness.rs WireData); kind in 'lrof'."""

    __slots__ = ("kind", "gate")

    LEFT, RIGHT, OUTPUT, FOURTH = 0, 1, 2, 3

    def __init__(self, kind: int, gate: int):
        self.kind = kind
        self.gate = gate

    def __eq__(self, other):
        return self.kind == other.kind and self.gate == other.gate

    def __repr__(self):
        return f"WireData({'LROF'[self.kind]}, {self.gate})"


_N_COEFFS = 12
_N_WIRES = 4


class Constraint:
    """Immutable-style builder for one gate (constraint.rs:48-120).

    Builder methods return a modified copy, matching the reference's
    by-value chaining so call sites read identically.
    """

    __slots__ = ("coefficients", "witnesses", "_has_public_input")

    def __init__(self):
        self.coefficients = [Fr.zero()] * _N_COEFFS
        self.witnesses = [ZERO] * _N_WIRES
        self._has_public_input = False

    def _copy(self) -> "Constraint":
        c = Constraint.__new__(Constraint)
        c.coefficients = list(self.coefficients)
        c.witnesses = list(self.witnesses)
        c._has_public_input = self._has_public_input
        return c

    @classmethod
    def from_external(cls, other: "Constraint") -> "Constraint":
        """Copy only the non-gate-family selectors (constraint.rs:from_external)."""
        c = cls()
        c.coefficients[: Selector.ARITHMETIC] = (
            other.coefficients[: Selector.ARITHMETIC])
        c.witnesses = list(other.witnesses)
        c._has_public_input = other._has_public_input
        return c

    def set(self, sel: Selector, value) -> "Constraint":
        # mutates in place and returns self: every call site immediately
        # rebinds the result, and Gate() snapshots coefficients/witnesses
        # at append time, so copy-on-set only burned time (~600k copies
        # per 2^16-gate witness synthesis)
        self.coefficients[sel] = value if isinstance(value, Fr) else Fr(int(value))
        return self

    def set_witness(self, which: WiredWitness, w: Witness) -> None:
        self.witnesses[which] = w

    def coeff(self, sel: Selector) -> Fr:
        return self.coefficients[sel]

    def witness(self, which: WiredWitness) -> Witness:
        return self.witnesses[which]

    # -- chained setters --------------------------------------------------------
    def mult(self, s):
        return self.set(Selector.MULTIPLICATION, s)

    def left(self, s):
        return self.set(Selector.LEFT, s)

    def right(self, s):
        return self.set(Selector.RIGHT, s)

    def output(self, s):
        return self.set(Selector.OUTPUT, s)

    def fourth(self, s):
        return self.set(Selector.FOURTH, s)

    def constant(self, s):
        return self.set(Selector.CONSTANT, s)

    def public(self, s):
        c = self.set(Selector.PUBLIC_INPUT, s)
        c._has_public_input = True
        return c

    def a(self, w: Witness):
        c = self._copy()
        c.witnesses[WiredWitness.A] = w
        return c

    def b(self, w: Witness):
        c = self._copy()
        c.witnesses[WiredWitness.B] = w
        return c

    def c(self, w: Witness):
        cc = self._copy()
        cc.witnesses[WiredWitness.C] = w
        return cc

    def d(self, w: Witness):
        c = self._copy()
        c.witnesses[WiredWitness.D] = w
        return c

    def has_public_input(self) -> bool:
        return self._has_public_input

    # -- gate-family taggers (constraint.rs:arithmetic..group_add_variable_base) --
    @staticmethod
    def arithmetic(s: "Constraint") -> "Constraint":
        return Constraint.from_external(s).set(Selector.ARITHMETIC, 1)

    @staticmethod
    def range(s: "Constraint") -> "Constraint":
        return Constraint.from_external(s).set(Selector.RANGE, 1)

    @staticmethod
    def logic(s: "Constraint") -> "Constraint":
        return (Constraint.from_external(s)
                .set(Selector.CONSTANT, 1)
                .set(Selector.LOGIC, 1))

    @staticmethod
    def logic_xor(s: "Constraint") -> "Constraint":
        return (Constraint.from_external(s)
                .set(Selector.CONSTANT, -Fr.one())
                .set(Selector.LOGIC, -Fr.one()))

    @staticmethod
    def group_add_fixed_base(s: "Constraint") -> "Constraint":
        return Constraint.from_external(s).set(Selector.GROUP_ADD_FIXED_BASE, 1)

    @staticmethod
    def group_add_variable_base(s: "Constraint") -> "Constraint":
        return Constraint.from_external(s).set(
            Selector.GROUP_ADD_VARIABLE_BASE, 1)


class Gate:
    """One materialized constraint row (composer/gate.rs:6)."""

    __slots__ = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith",
                 "q_range", "q_logic", "q_fixed_group_add",
                 "q_variable_group_add", "a", "b", "c", "d")

    def __init__(self, constraint: Constraint):
        co = constraint.coeff
        self.q_m = co(Selector.MULTIPLICATION)
        self.q_l = co(Selector.LEFT)
        self.q_r = co(Selector.RIGHT)
        self.q_o = co(Selector.OUTPUT)
        self.q_f = co(Selector.FOURTH)
        self.q_c = co(Selector.CONSTANT)
        self.q_arith = co(Selector.ARITHMETIC)
        self.q_range = co(Selector.RANGE)
        self.q_logic = co(Selector.LOGIC)
        self.q_fixed_group_add = co(Selector.GROUP_ADD_FIXED_BASE)
        self.q_variable_group_add = co(Selector.GROUP_ADD_VARIABLE_BASE)
        self.a = constraint.witness(WiredWitness.A)
        self.b = constraint.witness(WiredWitness.B)
        self.c = constraint.witness(WiredWitness.C)
        self.d = constraint.witness(WiredWitness.D)
