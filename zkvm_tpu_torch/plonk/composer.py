"""Constraint builder with the full gadget library (plonk/src/composer.rs).

Gate-for-gate parity with the reference Composer: identical witness
allocation order, identical selector contents, identical gate counts -- so
circuit sizes, preprocessed keys and proofs are bit-identical.  Everything
here is host-side circuit *description*; batched field work happens in the
prover.
"""

from __future__ import annotations

from ..curves.jubjub import JubjubAffine, JubjubExtended
from ..fields import Fr, JubjubFr
from ..utils import metrics
from . import errors
from .constraint_system import (Constraint, Gate, Selector, Witness,
                                WiredWitness, WitnessPoint)
from .permutation import Permutation

_Q = Fr.MODULUS


def _bits_msb(value: Fr, n: int = 256) -> list[int]:
    """MSB-first bit vector (bit_iterator.rs BitIterator8 over LE bytes)."""
    v = value.value
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


class Runtime:
    """Event bus for composer introspection (plonk/src/runtime.rs:12-47).

    Listeners receive ('witness_appended', w, v), ('constraint_appended', c)
    and ('proof_finished',) events; the CDF-style circuit debugger
    (`plonk/debugger.py` of this package) subscribes here.
    """

    def __init__(self):
        self.listeners = []

    def event(self, *payload) -> None:
        for listener in self.listeners:
            listener(*payload)


class Composer:
    """4-wire TurboPLONK circuit builder (composer.rs:29-1015)."""

    ZERO = Witness(0)
    ONE = Witness(1)
    IDENTITY = WitnessPoint(ZERO, ONE)

    def __init__(self):
        self.constraints: list[Gate] = []
        self.public_inputs: dict[int, Fr] = {}
        self.witnesses: list[Fr] = []
        self.perm = Permutation()
        self.runtime = Runtime()

    # -- construction -----------------------------------------------------------
    @classmethod
    def uninitialized(cls) -> "Composer":
        return cls()

    @classmethod
    def initialized(cls) -> "Composer":
        """Seed ZERO/ONE constants + 2 dummy gates (composer.rs:139-151)."""
        composer = cls.uninitialized()
        zero = composer.append_witness(0)
        one = composer.append_witness(1)
        composer.assert_equal_constant(zero, 0, None)
        composer.assert_equal_constant(one, 1, None)
        composer._append_dummy_gates()
        return composer

    def _append_dummy_gates(self):
        six = self.append_witness(Fr(6))
        one = self.append_witness(Fr(1))
        seven = self.append_witness(Fr(7))
        min_twenty = self.append_witness(-Fr(20))
        self.append_gate(Constraint().mult(1).left(2).right(3).fourth(1)
                         .constant(4).output(4)
                         .a(six).b(seven).d(one).c(min_twenty))
        self.append_gate(Constraint().mult(1).left(1).right(1).constant(127)
                         .output(1).a(min_twenty).b(six).c(seven))

    def __len__(self):
        return len(self.constraints)

    def constraint_count(self) -> int:
        return len(self.constraints)

    def __getitem__(self, witness: Witness) -> Fr:
        return self.witnesses[witness.index]

    # -- witness / gate plumbing -------------------------------------------------
    def append_witness(self, value) -> Witness:
        if isinstance(value, JubjubFr):
            value = Fr(value.value)
        elif not isinstance(value, Fr):
            value = Fr(int(value))
        witness = self.perm.new_witness()
        self.witnesses.append(value)
        if self.runtime.listeners:
            self.runtime.event("witness_appended", witness, value)
        return witness

    def append_custom_gate(self, constraint: Constraint) -> None:
        if self.runtime.listeners:
            self.runtime.event("constraint_appended", constraint)
        gate_index = len(self.constraints)
        self.constraints.append(Gate(constraint))
        if constraint.has_public_input():
            self.public_inputs[gate_index] = constraint.coeff(
                Selector.PUBLIC_INPUT)
        self.perm.add_witnesses_to_map(
            constraint.witness(WiredWitness.A),
            constraint.witness(WiredWitness.B),
            constraint.witness(WiredWitness.C),
            constraint.witness(WiredWitness.D),
            gate_index)

    def append_gate(self, constraint: Constraint) -> None:
        self.append_custom_gate(Constraint.arithmetic(constraint))

    def append_evaluated_output(self, s: Constraint) -> Witness | None:
        """Evaluate the arithmetic polynomial and allocate -o/q_o
        (composer.rs:451-501).

        Runs on raw ints (one Fr at the end) with a fast path for the
        ubiquitous q_o = -1: this is called once per gate_add and the Fr
        operator churn plus a per-gate modular inversion dominated it."""
        q = Fr.MODULUS
        w = self.witnesses
        sw = s.witnesses
        a = w[sw[WiredWitness.A].index].value
        b = w[sw[WiredWitness.B].index].value
        d = w[sw[WiredWitness.D].index].value
        co = s.coefficients
        value = (co[Selector.MULTIPLICATION].value * a * b
                 + co[Selector.LEFT].value * a
                 + co[Selector.RIGHT].value * b
                 + co[Selector.FOURTH].value * d
                 + co[Selector.CONSTANT].value
                 + co[Selector.PUBLIC_INPUT].value) % q
        q_o = co[Selector.OUTPUT].value
        if q_o == q - 1:          # -o/q_o = o for q_o = -1
            return self.append_witness(Fr(value))
        if q_o == 0:
            return None
        inv = pow(q_o, -1, q)
        return self.append_witness(Fr(-value * inv % q))

    # -- basic gadgets ------------------------------------------------------------
    def append_constant(self, constant) -> Witness:
        constant = constant if isinstance(constant, Fr) else Fr(int(constant))
        witness = self.append_witness(constant)
        self.assert_equal_constant(witness, constant, None)
        return witness

    def append_public(self, public) -> Witness:
        public = public if isinstance(public, Fr) else Fr(int(public))
        witness = self.append_witness(public)
        self.append_gate(Constraint().left(-Fr.one()).a(witness).public(public))
        return witness

    def assert_equal(self, left: Witness, right: Witness) -> None:
        self.append_gate(Constraint().left(1).right(-Fr.one()).a(left).b(right))

    def assert_equal_constant(self, witness: Witness, constant,
                              public: Fr | None) -> None:
        constant = constant if isinstance(constant, Fr) else Fr(int(constant))
        constraint = Constraint().left(-Fr.one()).a(witness).constant(constant)
        if public is not None:
            constraint = constraint.public(public)
        self.append_gate(constraint)

    def gate_add(self, constraint: Constraint) -> Witness:
        arithmetic = Constraint.arithmetic(constraint).output(-Fr.one())
        output = self.append_evaluated_output(arithmetic)
        assert output is not None, "output selector is -1"
        self.append_gate(arithmetic.c(output))
        return output

    gate_mul = gate_add  # identical mechanics (composer.rs:936-962)

    def component_boolean(self, witness: Witness) -> None:
        self.append_gate(Constraint().mult(1).output(-Fr.one())
                         .a(witness).b(witness).c(witness).d(self.ZERO))

    def component_decomposition(self, scalar: Witness, n: int) -> list[Witness]:
        """LSB-first bit decomposition, N boolean-constrained bits
        (composer.rs:718-749)."""
        assert 0 < n <= 256
        acc = self.ZERO
        decomposition = []
        bits = self[scalar].to_bits()
        for i in range(n):
            w_bit = self.append_witness(Fr(bits[i]))
            self.component_boolean(w_bit)
            decomposition.append(w_bit)
            acc = self.gate_add(Constraint()
                                .left(Fr(1 << i))
                                .right(1).a(w_bit).b(acc))
        self.assert_equal(acc, scalar)
        return decomposition

    def component_select(self, bit: Witness, a: Witness, b: Witness) -> Witness:
        bit_times_a = self.gate_mul(Constraint().mult(1).a(bit).b(a))
        one_min_bit = self.gate_add(
            Constraint().left(-Fr.one()).constant(1).a(bit))
        one_min_bit_b = self.gate_mul(
            Constraint().mult(1).a(one_min_bit).b(b))
        return self.gate_add(Constraint().left(1).right(1)
                             .a(one_min_bit_b).b(bit_times_a))

    def component_select_zero(self, bit: Witness, value: Witness) -> Witness:
        return self.gate_mul(Constraint().mult(1).a(bit).b(value))

    def component_select_one(self, bit: Witness, value: Witness) -> Witness:
        bit_value = self[bit]
        output_value = Fr.one() - bit_value + bit_value * self[value]
        output = self.append_witness(output_value)
        self.append_gate(Constraint().mult(1).left(-Fr.one())
                         .output(-Fr.one()).constant(1)
                         .a(bit).b(value).c(output))
        return output

    def component_select_point(self, bit: Witness, left: WitnessPoint,
                               right: WitnessPoint) -> WitnessPoint:
        return WitnessPoint(
            self.component_select(bit, left.x, right.x),
            self.component_select(bit, left.y, right.y))

    def component_select_identity(self, bit: Witness,
                                  point: WitnessPoint) -> WitnessPoint:
        return WitnessPoint(
            self.component_select_zero(bit, point.x),
            self.component_select_one(bit, point.y))

    # -- range / logic gadgets -----------------------------------------------------
    def component_range(self, witness: Witness, bit_pairs: int) -> None:
        """Base-4 accumulator range proof (composer.rs:855-934)."""
        num_bits = min(bit_pairs * 2, 256)
        if num_bits == 0:
            self.append_gate(Constraint().left(1).a(witness))
            return
        bits = list(reversed(_bits_msb(self[witness])))  # LSB-first

        num_gates = num_bits >> 3
        if num_bits % 8 != 0:
            num_gates += 1
        num_quads = num_gates * 4
        pad = 1 + (((num_quads << 1) - num_bits) >> 1)
        used_gates = num_gates + 1

        constraints = [Constraint.range(Constraint())
                       for _ in range(used_gates)]
        accumulators: list[Witness] = []
        accumulator = Fr.zero()
        for i in range(pad, num_quads + 1):
            bit_index = (num_quads - i) << 1
            quad = bits[bit_index] + 2 * bits[bit_index + 1]
            accumulator = Fr(4) * accumulator + Fr(quad)
            accumulator_var = self.append_witness(accumulator)
            accumulators.append(accumulator_var)
            idx = i // 4
            which = (WiredWitness.D, WiredWitness.C,
                     WiredWitness.B, WiredWitness.A)[i % 4]
            constraints[idx].set_witness(which, accumulator_var)

        last = Constraint()
        if accumulators:
            last.set_witness(WiredWitness.D, accumulators[-1])
        constraints[-1] = last
        for constraint in constraints:
            self.append_custom_gate(constraint)
        if accumulators:
            self.assert_equal(accumulators[-1], witness)

    def append_logic_component(self, a: Witness, b: Witness, bit_pairs: int,
                               is_xor: bool) -> Witness:
        """Quad-wise AND/XOR accumulation gates (composer.rs:224-313)."""
        num_bits = min(bit_pairs * 2, 256)
        num_quads = num_bits >> 1
        a_bits = _bits_msb(self[a])[256 - num_bits:]
        b_bits = _bits_msb(self[b])[256 - num_bits:]

        left_acc = right_acc = out_acc = Fr.zero()
        constraint = (Constraint.logic_xor(Constraint()) if is_xor
                      else Constraint.logic(Constraint()))
        for i in range(num_quads):
            idx = i * 2
            left_quad = (a_bits[idx] << 1) + a_bits[idx + 1]
            right_quad = (b_bits[idx] << 1) + b_bits[idx + 1]
            out_quad = (left_quad ^ right_quad) if is_xor else (left_quad & right_quad)
            prod_quad = left_quad * right_quad

            left_acc = left_acc * Fr(4) + Fr(left_quad)
            right_acc = right_acc * Fr(4) + Fr(right_quad)
            out_acc = out_acc * Fr(4) + Fr(out_quad)

            wit_a = self.append_witness(left_acc)
            wit_b = self.append_witness(right_acc)
            wit_c = self.append_witness(Fr(prod_quad))
            wit_d = self.append_witness(out_acc)

            constraint = constraint.c(wit_c)
            self.append_custom_gate(constraint)
            constraint = constraint.a(wit_a).b(wit_b).d(wit_d)

        left_w = constraint.witness(WiredWitness.A)
        right_w = constraint.witness(WiredWitness.B)
        fourth_w = constraint.witness(WiredWitness.D)
        self.append_custom_gate(Constraint().a(left_w).b(right_w).d(fourth_w))
        return fourth_w

    def append_logic_and(self, a: Witness, b: Witness, bit_pairs: int) -> Witness:
        return self.append_logic_component(a, b, bit_pairs, False)

    def append_logic_xor(self, a: Witness, b: Witness, bit_pairs: int) -> Witness:
        return self.append_logic_component(a, b, bit_pairs, True)

    # -- ECC gadgets (Jubjub embedded curve) -----------------------------------------
    def append_point(self, affine: JubjubAffine) -> WitnessPoint:
        return WitnessPoint(self.append_witness(affine.u),
                            self.append_witness(affine.v))

    def append_constant_point(self, affine: JubjubAffine) -> WitnessPoint:
        return WitnessPoint(self.append_constant(affine.u),
                            self.append_constant(affine.v))

    def append_public_point(self, affine: JubjubAffine) -> WitnessPoint:
        point = self.append_point(affine)
        self.assert_equal_constant(point.x, Fr.zero(), affine.u)
        self.assert_equal_constant(point.y, Fr.zero(), affine.v)
        return point

    def assert_equal_point(self, left: WitnessPoint, right: WitnessPoint):
        self.assert_equal(left.x, right.x)
        self.assert_equal(left.y, right.y)

    def assert_equal_public_point(self, point: WitnessPoint,
                                  public: JubjubAffine):
        self.assert_equal_constant(point.x, Fr.zero(), public.u)
        self.assert_equal_constant(point.y, Fr.zero(), public.v)

    def component_neg_point(self, point: WitnessPoint) -> WitnessPoint:
        neg_x = self.gate_mul(Constraint().left(-Fr.one()).a(point.x))
        return WitnessPoint(neg_x, point.y)

    def component_add_point(self, a: WitnessPoint,
                            b: WitnessPoint) -> WitnessPoint:
        """Edwards addition via the variable-base group widget
        (composer.rs:669-703)."""
        x1, y1, x2, y2 = a.x, a.y, b.x, b.y
        fq = lambda w: self[w]
        p1 = JubjubAffine(fq(x1), fq(y1))
        p2 = JubjubAffine(fq(x2), fq(y2))
        p3 = (p1.to_extended() + p2.to_extended()).to_affine()

        x_1_y_2 = self.append_witness(fq(x1) * fq(y2))
        x3 = self.append_witness(p3.u)
        y3 = self.append_witness(p3.v)

        self.append_custom_gate(Constraint.group_add_variable_base(
            Constraint().a(x1).b(y1).c(x2).d(y2)))
        self.append_custom_gate(Constraint().a(x3).b(y3).d(x_1_y_2))
        return WitnessPoint(x3, y3)

    def component_sub_point(self, a: WitnessPoint,
                            b: WitnessPoint) -> WitnessPoint:
        return self.component_add_point(a, self.component_neg_point(b))

    def component_mul_point(self, jubjub: Witness,
                            point: WitnessPoint) -> WitnessPoint:
        """Variable-base scalar mul: 252-bit decompose + double-and-add
        (composer.rs:762-779); the span `prove/jubjub_variable_base`."""
        with metrics.GLOBAL.span("prove/jubjub_variable_base"):
            scalar_bits = self.component_decomposition(jubjub, 252)
            result = self.IDENTITY
            for bit in reversed(scalar_bits):
                result = self.component_add_point(result, result)
                to_add = self.component_select_identity(bit, point)
                result = self.component_add_point(result, to_add)
        return result

    def component_mul_generator(self, jubjub: Witness,
                                generator) -> WitnessPoint:
        """Fixed-base scalar mul: 256 WNAF-2 gates (composer.rs:315-443);
        the span `prove/jubjub_fixed_base`."""
        with metrics.GLOBAL.span("prove/jubjub_fixed_base"):
            return self._mul_generator(jubjub, generator)

    def _mul_generator(self, jubjub: Witness, generator) -> WitnessPoint:
        if isinstance(generator, JubjubAffine):
            generator = generator.to_extended()
        bits = 256
        multiples = [generator]
        for _ in range(1, bits):
            multiples.append(multiples[-1].double())
        wnaf_point_multiples = JubjubExtended.batch_normalize(multiples)
        wnaf_point_multiples.reverse()

        scalar = JubjubFr.from_bytes(self[jubjub].to_bytes())
        if scalar is None:
            raise errors.JubJubScalarMalformed()
        wnaf_entries = scalar.compute_windowed_naf(2)
        assert len(wnaf_entries) == bits

        scalar_acc = [Fr.zero()]
        point_acc = [JubjubAffine.identity()]
        xy_alphas = []
        for i, entry in enumerate(reversed(wnaf_entries)):
            if entry == 0:
                scalar_to_add, point_to_add = Fr.zero(), JubjubAffine.identity()
            elif entry == -1:
                scalar_to_add, point_to_add = -Fr.one(), -wnaf_point_multiples[i]
            elif entry == 1:
                scalar_to_add, point_to_add = Fr.one(), wnaf_point_multiples[i]
            else:
                raise errors.UnsupportedWNAF2k()
            scalar_acc.append(Fr(2) * scalar_acc[i] + scalar_to_add)
            point_acc.append(
                (point_acc[i].to_extended() + point_to_add.to_extended())
                .to_affine())
            xy_alphas.append(point_to_add.u * point_to_add.v)

        for i in range(bits):
            acc_x = self.append_witness(point_acc[i].u)
            acc_y = self.append_witness(point_acc[i].v)
            accumulated_bit = self.append_witness(scalar_acc[i])
            if i == 0:
                self.assert_equal_constant(acc_x, Fr.zero(), None)
                self.assert_equal_constant(acc_y, Fr.one(), None)
                self.assert_equal_constant(accumulated_bit, Fr.zero(), None)
            x_beta = wnaf_point_multiples[i].u
            y_beta = wnaf_point_multiples[i].v
            xy_alpha = self.append_witness(xy_alphas[i])
            xy_beta = x_beta * y_beta
            self.append_custom_gate(
                Constraint.group_add_fixed_base(Constraint())
                .left(x_beta).right(y_beta).constant(xy_beta)
                .a(acc_x).b(acc_y).c(xy_alpha).d(accumulated_bit))

        acc_x = self.append_witness(point_acc[bits].u)
        acc_y = self.append_witness(point_acc[bits].v)
        last_accumulated_bit = self.append_witness(scalar_acc[bits])
        self.append_gate(Constraint().a(acc_x).b(acc_y).d(last_accumulated_bit))
        self.assert_equal(last_accumulated_bit, jubjub)
        return WitnessPoint(acc_x, acc_y)

    # -- prove-time re-synthesis and PI helpers ---------------------------------------
    @classmethod
    def prove(cls, constraints: int, circuit) -> "Composer":
        """Re-synthesize the witness for proving (composer.rs:964-983)."""
        composer = cls.initialized()
        circuit.circuit(composer)
        if len(composer.constraints) != constraints:
            raise errors.InvalidCircuitSize(len(composer.constraints),
                                            constraints)
        composer.runtime.event("proof_finished")
        return composer

    def public_input_indexes(self) -> list[int]:
        return sorted(self.public_inputs.keys())

    def public_input_values(self) -> list[Fr]:
        return [self.public_inputs[i] for i in self.public_input_indexes()]

    @staticmethod
    def dense_public_inputs(indexes: list[int], values: list[Fr],
                            size: int) -> list[Fr]:
        dense = [Fr.zero()] * size
        for idx, pi in zip(indexes, values):
            dense[idx] = pi
        return dense


class Circuit:
    """Circuit interface (plonk/src/composer/circuit.rs:12-33)."""

    def circuit(self, composer: Composer) -> None:
        raise NotImplementedError

    def size(self) -> int:
        composer = Composer.initialized()
        try:
            self.circuit(composer)
        except Exception:
            return 0
        return len(composer.constraints)

    def compress(self) -> bytes:
        """Portable circuit description (circuit.rs:24-33)."""
        from .compress import CompressedCircuit

        composer = Composer.initialized()
        self.circuit(composer)
        return CompressedCircuit.from_composer(True, composer)
