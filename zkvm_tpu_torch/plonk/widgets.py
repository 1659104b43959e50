"""Widget prover/verifier keys and their quotient/linearization formulas.

Mirrors plonk/src/proof_system/widget/ -- arithmetic, range, logic,
fixed-base ECC, variable-base ECC, permutation -- plus the aggregate
ProverKey/VerifierKey with the reference byte layouts (widget.rs:30-521).

The per-gate quotient formulas are expressed over canonical python ints
(exact mod q); the prover evaluates them over the 8n coset domain.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import params
from ..fields import Fr
from .evaluations import Evaluations
from .kzg10 import Commitment
from .polynomial import Polynomial

_Q = Fr.MODULUS
_K1, _K2, _K3 = params.K1, params.K2, params.K3
_EDWARDS_D = params.JUBJUB_D


@dataclass
class ProofEvaluations:
    """The 15 proof evaluations (linearization_poly.rs:29-74)."""

    a_eval: Fr = None
    b_eval: Fr = None
    c_eval: Fr = None
    d_eval: Fr = None
    a_w_eval: Fr = None
    b_w_eval: Fr = None
    d_w_eval: Fr = None
    q_arith_eval: Fr = None
    q_c_eval: Fr = None
    q_l_eval: Fr = None
    q_r_eval: Fr = None
    s_sigma_1_eval: Fr = None
    s_sigma_2_eval: Fr = None
    s_sigma_3_eval: Fr = None
    z_eval: Fr = None

    _FIELDS = ("a_eval", "b_eval", "c_eval", "d_eval", "a_w_eval", "b_w_eval",
               "d_w_eval", "q_arith_eval", "q_c_eval", "q_l_eval", "q_r_eval",
               "s_sigma_1_eval", "s_sigma_2_eval", "s_sigma_3_eval", "z_eval")

    SIZE = 15 * 32

    def to_bytes(self) -> bytes:
        return b"".join(getattr(self, f).to_bytes() for f in self._FIELDS)

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) != cls.SIZE:
            return None
        vals = {}
        for i, f in enumerate(cls._FIELDS):
            v = Fr.from_bytes(buf[32 * i: 32 * i + 32])
            if v is None:
                return None
            vals[f] = v
        return cls(**vals)

    @classmethod
    def zero(cls):
        return cls(**{f: Fr.zero() for f in cls._FIELDS})


def delta(f: int) -> int:
    """f(f-1)(f-2)(f-3) mod q (range/proverkey.rs delta)."""
    return f * (f - 1) % _Q * ((f - 2) % _Q) % _Q * ((f - 3) % _Q) % _Q


def delta_xor_and(a: int, b: int, w: int, c: int, q_c: int) -> int:
    """Choice polynomial for the logic widget (logic/proverkey.rs:delta_xor_and)."""
    f = w * (w * (4 * w - 18 * (a + b) + 81)
             + 18 * (a * a % _Q + b * b % _Q) - 81 * (a + b) + 83) % _Q
    e = (3 * (a + b + c) - 2 * f) % _Q
    bb = q_c * ((9 * c - 3 * (a + b)) % _Q) % _Q
    return (bb + e) % _Q


# -----------------------------------------------------------------------------
# Arithmetic widget (widget/arithmetic/)
# -----------------------------------------------------------------------------

@dataclass
class ArithmeticProverKey:
    q_m: tuple[Polynomial, Evaluations]
    q_l: tuple[Polynomial, Evaluations]
    q_r: tuple[Polynomial, Evaluations]
    q_o: tuple[Polynomial, Evaluations]
    q_f: tuple[Polynomial, Evaluations]
    q_c: tuple[Polynomial, Evaluations]
    q_arith: tuple[Polynomial, Evaluations]

    def compute_quotient_i(self, i, a, b, c, d) -> int:
        t = (self.q_m[1][i].value * a % _Q * b
             + self.q_l[1][i].value * a
             + self.q_r[1][i].value * b
             + self.q_o[1][i].value * c
             + self.q_f[1][i].value * d
             + self.q_c[1][i].value) % _Q
        return t * self.q_arith[1][i].value % _Q

    def compute_linearization(self, ev: ProofEvaluations) -> Polynomial:
        lin = (self.q_m[0].scale(ev.a_eval * ev.b_eval)
               + self.q_l[0].scale(ev.a_eval)
               + self.q_r[0].scale(ev.b_eval)
               + self.q_o[0].scale(ev.c_eval)
               + self.q_f[0].scale(ev.d_eval)
               + self.q_c[0])
        return lin.scale(ev.q_arith_eval)


@dataclass
class ArithmeticVerifierKey:
    q_m: Commitment
    q_l: Commitment
    q_r: Commitment
    q_o: Commitment
    q_f: Commitment
    q_c: Commitment
    q_arith: Commitment

    def compute_linearization_commitment(self, scalars, points,
                                         ev: ProofEvaluations):
        qa = ev.q_arith_eval
        scalars.append(ev.a_eval * ev.b_eval * qa)
        points.append(self.q_m.point)
        scalars.append(ev.a_eval * qa)
        points.append(self.q_l.point)
        scalars.append(ev.b_eval * qa)
        points.append(self.q_r.point)
        scalars.append(ev.c_eval * qa)
        points.append(self.q_o.point)
        scalars.append(ev.d_eval * qa)
        points.append(self.q_f.point)
        scalars.append(qa)
        points.append(self.q_c.point)


# -----------------------------------------------------------------------------
# Range widget (widget/range/)
# -----------------------------------------------------------------------------

def _range_identity(sep: int, a, b, c, d, d_w) -> int:
    kappa = sep * sep % _Q
    kappa_sq = kappa * kappa % _Q
    kappa_cu = kappa_sq * kappa % _Q
    t = (delta((c - 4 * d) % _Q)
         + delta((b - 4 * c) % _Q) * kappa
         + delta((a - 4 * b) % _Q) * kappa_sq
         + delta((d_w - 4 * a) % _Q) * kappa_cu) % _Q
    return t * sep % _Q


@dataclass
class RangeProverKey:
    q_range: tuple[Polynomial, Evaluations]

    def compute_quotient_i(self, i, sep: int, a, b, c, d, d_w) -> int:
        return (_range_identity(sep, a, b, c, d, d_w)
                * self.q_range[1][i].value % _Q)

    def compute_linearization(self, sep: Fr, ev: ProofEvaluations) -> Polynomial:
        term = _range_identity(sep.value, ev.a_eval.value, ev.b_eval.value,
                               ev.c_eval.value, ev.d_eval.value,
                               ev.d_w_eval.value)
        return self.q_range[0].scale(Fr(term))


@dataclass
class RangeVerifierKey:
    q_range: Commitment

    def compute_linearization_commitment(self, sep: Fr, scalars, points,
                                         ev: ProofEvaluations):
        term = _range_identity(sep.value, ev.a_eval.value, ev.b_eval.value,
                               ev.c_eval.value, ev.d_eval.value,
                               ev.d_w_eval.value)
        scalars.append(Fr(term))
        points.append(self.q_range.point)


# -----------------------------------------------------------------------------
# Logic widget (widget/logic/)
# -----------------------------------------------------------------------------

def _logic_identity(sep: int, a, a_w, b, b_w, c, d, d_w, q_c: int) -> int:
    kappa = sep * sep % _Q
    kappa_sq = kappa * kappa % _Q
    kappa_cu = kappa_sq * kappa % _Q
    kappa_qu = kappa_cu * kappa % _Q
    a_sd = (a_w - 4 * a) % _Q
    b_sd = (b_w - 4 * b) % _Q
    d_sd = (d_w - 4 * d) % _Q
    c_0 = delta(a_sd)
    c_1 = delta(b_sd) * kappa % _Q
    c_2 = delta(d_sd) * kappa_sq % _Q
    c_3 = (c - a_sd * b_sd) % _Q * kappa_cu % _Q
    c_4 = delta_xor_and(a_sd, b_sd, c, d_sd, q_c) * kappa_qu % _Q
    return (c_3 + c_0 + c_1 + c_2 + c_4) % _Q * sep % _Q


@dataclass
class LogicProverKey:
    q_c: tuple[Polynomial, Evaluations]
    q_logic: tuple[Polynomial, Evaluations]

    def compute_quotient_i(self, i, sep: int, a, a_w, b, b_w, c, d, d_w) -> int:
        return (self.q_logic[1][i].value
                * _logic_identity(sep, a, a_w, b, b_w, c, d, d_w,
                                  self.q_c[1][i].value) % _Q)

    def compute_linearization(self, sep: Fr, ev: ProofEvaluations) -> Polynomial:
        term = _logic_identity(sep.value, ev.a_eval.value, ev.a_w_eval.value,
                               ev.b_eval.value, ev.b_w_eval.value,
                               ev.c_eval.value, ev.d_eval.value,
                               ev.d_w_eval.value, ev.q_c_eval.value)
        return self.q_logic[0].scale(Fr(term))


@dataclass
class LogicVerifierKey:
    q_c: Commitment
    q_logic: Commitment

    def compute_linearization_commitment(self, sep: Fr, scalars, points,
                                         ev: ProofEvaluations):
        term = _logic_identity(sep.value, ev.a_eval.value, ev.a_w_eval.value,
                               ev.b_eval.value, ev.b_w_eval.value,
                               ev.c_eval.value, ev.d_eval.value,
                               ev.d_w_eval.value, ev.q_c_eval.value)
        scalars.append(Fr(term))
        points.append(self.q_logic.point)


# -----------------------------------------------------------------------------
# Fixed-base ECC widget (widget/ecc/scalar_mul/fixed_base/)
# -----------------------------------------------------------------------------

def _fixed_base_identity(sep: int, a, a_w, b, b_w, c, d, d_w,
                         x_beta: int, y_beta: int, q_c: int) -> int:
    kappa = sep * sep % _Q
    kappa_sq = kappa * kappa % _Q
    kappa_cu = kappa_sq * kappa % _Q
    acc_x, acc_x_w, acc_y, acc_y_w = a, a_w, b, b_w
    xy_alpha = c
    bit = (d_w - d - d) % _Q
    bit_consistency = bit * ((bit - 1) % _Q) % _Q * ((bit + 1) % _Q) % _Q
    y_alpha = (bit * bit % _Q * ((y_beta - 1) % _Q) + 1) % _Q
    x_alpha = bit * x_beta % _Q
    xy_consistency = (bit * q_c - xy_alpha) % _Q * kappa % _Q
    exd = acc_x * acc_y % _Q * _EDWARDS_D % _Q
    x_lhs = (acc_x_w + acc_x_w * xy_alpha % _Q * exd) % _Q
    x_rhs = (acc_x * y_alpha + acc_y * x_alpha) % _Q
    x_acc = (x_lhs - x_rhs) % _Q * kappa_sq % _Q
    y_lhs = (acc_y_w - acc_y_w * xy_alpha % _Q * exd) % _Q
    y_rhs = (acc_y * y_alpha + acc_x * x_alpha) % _Q
    y_acc = (y_lhs - y_rhs) % _Q * kappa_cu % _Q
    return (bit_consistency + x_acc + y_acc + xy_consistency) % _Q * sep % _Q


@dataclass
class FixedBaseProverKey:
    q_l: tuple[Polynomial, Evaluations]
    q_r: tuple[Polynomial, Evaluations]
    q_c: tuple[Polynomial, Evaluations]
    q_fixed_group_add: tuple[Polynomial, Evaluations]

    def compute_quotient_i(self, i, sep: int, a, a_w, b, b_w, c, d, d_w) -> int:
        identity = _fixed_base_identity(
            sep, a, a_w, b, b_w, c, d, d_w,
            self.q_l[1][i].value, self.q_r[1][i].value, self.q_c[1][i].value)
        return identity * self.q_fixed_group_add[1][i].value % _Q

    def compute_linearization(self, sep: Fr, ev: ProofEvaluations) -> Polynomial:
        term = _fixed_base_identity(
            sep.value, ev.a_eval.value, ev.a_w_eval.value, ev.b_eval.value,
            ev.b_w_eval.value, ev.c_eval.value, ev.d_eval.value,
            ev.d_w_eval.value, ev.q_l_eval.value, ev.q_r_eval.value,
            ev.q_c_eval.value)
        return self.q_fixed_group_add[0].scale(Fr(term))


@dataclass
class FixedBaseVerifierKey:
    q_l: Commitment
    q_r: Commitment
    q_fixed_group_add: Commitment

    def compute_linearization_commitment(self, sep: Fr, scalars, points,
                                         ev: ProofEvaluations):
        term = _fixed_base_identity(
            sep.value, ev.a_eval.value, ev.a_w_eval.value, ev.b_eval.value,
            ev.b_w_eval.value, ev.c_eval.value, ev.d_eval.value,
            ev.d_w_eval.value, ev.q_l_eval.value, ev.q_r_eval.value,
            ev.q_c_eval.value)
        scalars.append(Fr(term))
        points.append(self.q_fixed_group_add.point)


# -----------------------------------------------------------------------------
# Variable-base ECC widget (widget/ecc/curve_addition/)
# -----------------------------------------------------------------------------

def _var_base_identity(sep: int, a, a_w, b, b_w, c, d, d_w) -> int:
    kappa = sep * sep % _Q
    x1, x3, y1, y3 = a, a_w, b, b_w
    x2, y2, x1y2 = c, d, d_w
    xy_consistency = (x1 * y2 - x1y2) % _Q
    y1x2 = y1 * x2 % _Q
    y1y2 = y1 * y2 % _Q
    x1x2 = x1 * x2 % _Q
    mix = _EDWARDS_D * x1y2 % _Q * y1x2 % _Q
    x3_lhs = (x1y2 + y1x2) % _Q
    x3_rhs = (x3 + x3 * mix) % _Q
    x3_consistency = (x3_lhs - x3_rhs) % _Q * kappa % _Q
    y3_lhs = (y1y2 + x1x2) % _Q
    y3_rhs = (y3 - y3 * mix) % _Q
    y3_consistency = (y3_lhs - y3_rhs) % _Q * (kappa * kappa % _Q) % _Q
    return (xy_consistency + x3_consistency + y3_consistency) % _Q * sep % _Q


@dataclass
class VariableBaseProverKey:
    q_variable_group_add: tuple[Polynomial, Evaluations]

    def compute_quotient_i(self, i, sep: int, a, a_w, b, b_w, c, d, d_w) -> int:
        return (_var_base_identity(sep, a, a_w, b, b_w, c, d, d_w)
                * self.q_variable_group_add[1][i].value % _Q)

    def compute_linearization(self, sep: Fr, ev: ProofEvaluations) -> Polynomial:
        term = _var_base_identity(
            sep.value, ev.a_eval.value, ev.a_w_eval.value, ev.b_eval.value,
            ev.b_w_eval.value, ev.c_eval.value, ev.d_eval.value,
            ev.d_w_eval.value)
        return self.q_variable_group_add[0].scale(Fr(term))


@dataclass
class VariableBaseVerifierKey:
    q_variable_group_add: Commitment

    def compute_linearization_commitment(self, sep: Fr, scalars, points,
                                         ev: ProofEvaluations):
        term = _var_base_identity(
            sep.value, ev.a_eval.value, ev.a_w_eval.value, ev.b_eval.value,
            ev.b_w_eval.value, ev.c_eval.value, ev.d_eval.value,
            ev.d_w_eval.value)
        scalars.append(Fr(term))
        points.append(self.q_variable_group_add.point)


# -----------------------------------------------------------------------------
# Permutation widget (widget/permutation/)
# -----------------------------------------------------------------------------

@dataclass
class PermutationProverKey:
    s_sigma_1: tuple[Polynomial, Evaluations]
    s_sigma_2: tuple[Polynomial, Evaluations]
    s_sigma_3: tuple[Polynomial, Evaluations]
    s_sigma_4: tuple[Polynomial, Evaluations]
    linear_evaluations: Evaluations

    def compute_quotient_i(self, i, a, b, c, d, z, z_w,
                           alpha: int, l1_alpha_sq: int,
                           beta: int, gamma: int) -> int:
        x = self.linear_evaluations[i].value
        bx = beta * x % _Q
        identity = ((a + bx + gamma) % _Q
                    * ((b + bx * _K1 + gamma) % _Q) % _Q
                    * ((c + bx * _K2 + gamma) % _Q) % _Q
                    * ((d + bx * _K3 + gamma) % _Q) % _Q
                    * z % _Q * alpha % _Q)
        copy = ((a + beta * self.s_sigma_1[1][i].value + gamma) % _Q
                * ((b + beta * self.s_sigma_2[1][i].value + gamma) % _Q) % _Q
                * ((c + beta * self.s_sigma_3[1][i].value + gamma) % _Q) % _Q
                * ((d + beta * self.s_sigma_4[1][i].value + gamma) % _Q) % _Q
                * z_w % _Q * alpha % _Q)
        one_check = (z - 1) % _Q * l1_alpha_sq % _Q
        return (identity - copy + one_check) % _Q

    def compute_linearization(self, z_challenge: Fr, abg, evals4, sigmas3,
                              z_eval: Fr, z_poly: Polynomial,
                              domain) -> Polynomial:
        alpha, beta, gamma = abg
        a_eval, b_eval, c_eval, d_eval = evals4
        s1_eval, s2_eval, s3_eval = sigmas3
        beta_z = beta * z_challenge
        acc = ((a_eval + beta_z + gamma)
               * (b_eval + Fr(_K1) * beta_z + gamma)
               * (c_eval + Fr(_K2) * beta_z + gamma)
               * (d_eval + Fr(_K3) * beta_z + gamma) * alpha)
        identity_lin = z_poly.scale(acc)
        copy_acc = ((a_eval + beta * s1_eval + gamma)
                    * (b_eval + beta * s2_eval + gamma)
                    * (c_eval + beta * s3_eval + gamma)
                    * (beta * z_eval) * alpha)
        copy_lin = self.s_sigma_4[0].scale(-copy_acc)
        l_1_z = domain.evaluate_all_lagrange_coefficients(z_challenge)[0]
        one_lin = z_poly.scale(l_1_z * alpha.square())
        return identity_lin + copy_lin + one_lin


@dataclass
class PermutationVerifierKey:
    s_sigma_1: Commitment
    s_sigma_2: Commitment
    s_sigma_3: Commitment
    s_sigma_4: Commitment

    def compute_linearization_commitment(self, scalars, points,
                                         ev: ProofEvaluations,
                                         z_challenge: Fr, u_challenge: Fr,
                                         abg, l1_eval: Fr, z_comm):
        alpha, beta, gamma = abg
        alpha_sq = alpha.square()
        beta_z = beta * z_challenge
        identity_term = ((ev.a_eval + beta_z + gamma)
                         * (ev.b_eval + beta * Fr(_K1) * z_challenge + gamma)
                         * (ev.c_eval + beta * Fr(_K2) * z_challenge + gamma)
                         * ((ev.d_eval + beta * Fr(_K3) * z_challenge + gamma)
                            * alpha))
        scalars.append(identity_term + l1_eval * alpha_sq + u_challenge)
        points.append(z_comm)
        copy_term = -((ev.a_eval + beta * ev.s_sigma_1_eval + gamma)
                      * (ev.b_eval + beta * ev.s_sigma_2_eval + gamma)
                      * (ev.c_eval + beta * ev.s_sigma_3_eval + gamma)
                      * (beta * ev.z_eval * alpha))
        scalars.append(copy_term)
        points.append(self.s_sigma_4.point)


# -----------------------------------------------------------------------------
# Aggregate keys (widget.rs VerifierKey / ProverKey)
# -----------------------------------------------------------------------------

@dataclass
class VerifierKey:
    n: int
    arithmetic: ArithmeticVerifierKey
    logic: LogicVerifierKey
    range: RangeVerifierKey
    fixed_base: FixedBaseVerifierKey
    variable_base: VariableBaseVerifierKey
    permutation: PermutationVerifierKey

    # the reference allocates 20 commitment slots but writes only 15; the
    # remainder stays zero padding (widget.rs:57 Serializable size)
    SIZE = 20 * 48 + 8

    @classmethod
    def from_polynomial_commitments(cls, n, q_m, q_l, q_r, q_o, q_f, q_c,
                                    q_arith, q_logic, q_range,
                                    q_fixed_group_add, q_variable_group_add,
                                    s1, s2, s3, s4) -> "VerifierKey":
        return cls(
            n=n,
            arithmetic=ArithmeticVerifierKey(q_m, q_l, q_r, q_o, q_f, q_c,
                                             q_arith),
            logic=LogicVerifierKey(q_c, q_logic),
            range=RangeVerifierKey(q_range),
            fixed_base=FixedBaseVerifierKey(q_l, q_r, q_fixed_group_add),
            variable_base=VariableBaseVerifierKey(q_variable_group_add),
            permutation=PermutationVerifierKey(s1, s2, s3, s4))

    def to_bytes(self) -> bytes:
        body = (int(self.n).to_bytes(8, "little")
                + self.arithmetic.q_m.to_bytes()
                + self.arithmetic.q_l.to_bytes()
                + self.arithmetic.q_r.to_bytes()
                + self.arithmetic.q_o.to_bytes()
                + self.arithmetic.q_f.to_bytes()
                + self.arithmetic.q_c.to_bytes()
                + self.arithmetic.q_arith.to_bytes()
                + self.logic.q_logic.to_bytes()
                + self.range.q_range.to_bytes()
                + self.fixed_base.q_fixed_group_add.to_bytes()
                + self.variable_base.q_variable_group_add.to_bytes()
                + self.permutation.s_sigma_1.to_bytes()
                + self.permutation.s_sigma_2.to_bytes()
                + self.permutation.s_sigma_3.to_bytes()
                + self.permutation.s_sigma_4.to_bytes())
        return body + bytes(self.SIZE - len(body))

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) < 8 + 15 * 48:
            return None
        n = int.from_bytes(buf[:8], "little")
        comms = []
        for i in range(15):
            c = Commitment.from_bytes(buf[8 + 48 * i: 8 + 48 * (i + 1)])
            if c is None:
                return None
            comms.append(c)
        return cls.from_polynomial_commitments(n, *comms)

    def seed_transcript(self, transcript) -> None:
        """Bind all commitments + n (widget.rs seed_transcript).

        Reproduces the reference byte-exactly, including its quirk of
        appending s_sigma_1 under the label "s_sigma_4" (widget.rs:199)."""
        t = transcript
        t.append_commitment(b"q_m", self.arithmetic.q_m)
        t.append_commitment(b"q_l", self.arithmetic.q_l)
        t.append_commitment(b"q_r", self.arithmetic.q_r)
        t.append_commitment(b"q_o", self.arithmetic.q_o)
        t.append_commitment(b"q_c", self.arithmetic.q_c)
        t.append_commitment(b"q_f", self.arithmetic.q_f)
        t.append_commitment(b"q_arith", self.arithmetic.q_arith)
        t.append_commitment(b"q_range", self.range.q_range)
        t.append_commitment(b"q_logic", self.logic.q_logic)
        t.append_commitment(b"q_variable_group_add",
                            self.variable_base.q_variable_group_add)
        t.append_commitment(b"q_fixed_group_add",
                            self.fixed_base.q_fixed_group_add)
        t.append_commitment(b"s_sigma_1", self.permutation.s_sigma_1)
        t.append_commitment(b"s_sigma_2", self.permutation.s_sigma_2)
        t.append_commitment(b"s_sigma_3", self.permutation.s_sigma_3)
        t.append_commitment(b"s_sigma_4", self.permutation.s_sigma_1)
        t.circuit_domain_sep(self.n)


@dataclass
class ProverKey:
    n: int
    arithmetic: ArithmeticProverKey
    logic: LogicProverKey
    range: RangeProverKey
    fixed_base: FixedBaseProverKey
    variable_base: VariableBaseProverKey
    permutation: PermutationProverKey
    v_h_coset_8n: Evaluations

    # serialization (widget.rs to_var_bytes / from_slice); order and layout
    # match the reference: per entry u64 poly len + poly + evals blob
    _PAIRS = (("arithmetic", "q_m"), ("arithmetic", "q_l"),
              ("arithmetic", "q_r"), ("arithmetic", "q_o"),
              ("arithmetic", "q_f"), ("arithmetic", "q_c"),
              ("arithmetic", "q_arith"), ("logic", "q_logic"),
              ("range", "q_range"), ("fixed_base", "q_fixed_group_add"),
              ("variable_base", "q_variable_group_add"),
              ("permutation", "s_sigma_1"), ("permutation", "s_sigma_2"),
              ("permutation", "s_sigma_3"), ("permutation", "s_sigma_4"))

    @staticmethod
    def _domain_bytes(domain) -> bytes:
        """EvaluationDomain 172-byte layout (fft/domain.rs:46-66)."""
        return (int(domain.size).to_bytes(8, "little")
                + int(domain.log_size).to_bytes(4, "little")
                + Fr(domain.size).to_bytes()
                + Fr(domain.size_inv).to_bytes()
                + Fr(domain.group_gen).to_bytes()
                + Fr(domain.group_gen_inv).to_bytes()
                + Fr(domain.generator_inv).to_bytes())

    DOMAIN_SIZE_BYTES = 8 + 4 + 5 * 32

    def _evals_blob(self, evals: Evaluations) -> bytes:
        """Evaluations::to_var_bytes: domain header then the evals
        (fft/evaluations.rs:40-49)."""
        return (self._domain_bytes(evals.domain)
                + b"".join(e.to_bytes() for e in evals.evals))

    def to_var_bytes(self) -> bytes:
        out = int(self.n).to_bytes(8, "little")
        eval_size = self.DOMAIN_SIZE_BYTES + len(self.arithmetic.q_m[1]) * 32
        out += eval_size.to_bytes(8, "little")
        for fam, name in self._PAIRS:
            poly, evals = getattr(getattr(self, fam), name)
            out += len(poly.coeffs).to_bytes(8, "little")
            out += b"".join(c.to_bytes() for c in poly.coeffs)
            out += self._evals_blob(evals)
        out += self._evals_blob(self.permutation.linear_evaluations)
        out += self._evals_blob(self.v_h_coset_8n)
        return out

    @classmethod
    def from_slice(cls, buf: bytes) -> "ProverKey":
        from ..ops.ntt import Domain

        pos = 0

        def read_u64():
            nonlocal pos
            v = int.from_bytes(buf[pos: pos + 8], "little")
            pos += 8
            return v

        n = read_u64()
        eval_size = read_u64()
        dom_hdr = cls.DOMAIN_SIZE_BYTES

        def read_poly():
            nonlocal pos
            ln = read_u64()
            coeffs = [Fr.from_bytes(buf[pos + 32 * i: pos + 32 * (i + 1)])
                      for i in range(ln)]
            pos += 32 * ln
            return Polynomial(coeffs)

        def read_evals():
            nonlocal pos
            dsize = int.from_bytes(buf[pos: pos + 8], "little")
            count = (eval_size - dom_hdr) // 32
            base = pos + dom_hdr
            evals = [Fr.from_bytes(buf[base + 32 * i: base + 32 * (i + 1)])
                     for i in range(count)]
            pos += eval_size
            return Evaluations(evals, Domain(dsize))

        pairs = {}
        for fam, name in cls._PAIRS:
            poly = read_poly()
            evals = read_evals()
            pairs[name] = (poly, evals)
        linear = read_evals()
        v_h = read_evals()
        return cls(
            n=n,
            arithmetic=ArithmeticProverKey(
                pairs["q_m"], pairs["q_l"], pairs["q_r"], pairs["q_o"],
                pairs["q_f"], pairs["q_c"], pairs["q_arith"]),
            logic=LogicProverKey(pairs["q_c"], pairs["q_logic"]),
            range=RangeProverKey(pairs["q_range"]),
            fixed_base=FixedBaseProverKey(pairs["q_l"], pairs["q_r"],
                                          pairs["q_c"],
                                          pairs["q_fixed_group_add"]),
            variable_base=VariableBaseProverKey(
                pairs["q_variable_group_add"]),
            permutation=PermutationProverKey(
                pairs["s_sigma_1"], pairs["s_sigma_2"], pairs["s_sigma_3"],
                pairs["s_sigma_4"], linear),
            v_h_coset_8n=v_h)
