"""Proof object: serialization + verification equation
(plonk/src/proof_system/proof.rs).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.g1 import G1Affine, G1Projective
from ..curves.msm import msm_host
from ..curves.pairing import Gt, final_exponentiation, multi_miller_loop
from ..fields import Fr
from ..ops.ntt import Domain, _batch_inverse
from .errors import ProofVerificationError
from .kzg10 import Commitment, OpeningKey
from .transcript import Transcript
from .widgets import ProofEvaluations, VerifierKey

_Q = Fr.MODULUS

V_MAX_DEGREE = 7


@dataclass
class Proof:
    """11 commitments + 15 evaluations (proof.rs:22-66)."""

    a_comm: Commitment
    b_comm: Commitment
    c_comm: Commitment
    d_comm: Commitment
    z_comm: Commitment
    t_low_comm: Commitment
    t_mid_comm: Commitment
    t_high_comm: Commitment
    t_fourth_comm: Commitment
    w_z_chall_comm: Commitment
    w_z_chall_w_comm: Commitment
    evaluations: ProofEvaluations

    SIZE = 11 * 48 + ProofEvaluations.SIZE

    _COMMS = ("a_comm", "b_comm", "c_comm", "d_comm", "z_comm", "t_low_comm",
              "t_mid_comm", "t_high_comm", "t_fourth_comm", "w_z_chall_comm",
              "w_z_chall_w_comm")

    def to_bytes(self) -> bytes:
        return (b"".join(getattr(self, c).to_bytes() for c in self._COMMS)
                + self.evaluations.to_bytes())

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) != cls.SIZE:
            return None
        comms = []
        for i in range(11):
            c = Commitment.from_bytes(buf[48 * i: 48 * (i + 1)])
            if c is None:
                return None
            comms.append(c)
        evals = ProofEvaluations.from_bytes(buf[11 * 48:])
        if evals is None:
            return None
        return cls(*comms, evals)

    # -- verification (proof.rs:179-404) ----------------------------------------
    def verify(self, verifier_key: VerifierKey, transcript: Transcript,
               opening_key: OpeningKey, pub_inputs: list[Fr]) -> None:
        domain = Domain(
            1 if verifier_key.n <= 1
            else 1 << (verifier_key.n - 1).bit_length())
        ev = self.evaluations

        transcript.append_commitment(b"a_comm", self.a_comm)
        transcript.append_commitment(b"b_comm", self.b_comm)
        transcript.append_commitment(b"c_comm", self.c_comm)
        transcript.append_commitment(b"d_comm", self.d_comm)
        beta = transcript.challenge_scalar(b"beta")
        transcript.append_scalar(b"beta", beta)
        gamma = transcript.challenge_scalar(b"gamma")
        transcript.append_commitment(b"z_comm", self.z_comm)
        alpha = transcript.challenge_scalar(b"alpha")
        range_sep = transcript.challenge_scalar(b"range separation challenge")
        logic_sep = transcript.challenge_scalar(b"logic separation challenge")
        fixed_sep = transcript.challenge_scalar(
            b"fixed base separation challenge")
        var_sep = transcript.challenge_scalar(
            b"variable base separation challenge")
        transcript.append_commitment(b"t_low_comm", self.t_low_comm)
        transcript.append_commitment(b"t_mid_comm", self.t_mid_comm)
        transcript.append_commitment(b"t_high_comm", self.t_high_comm)
        transcript.append_commitment(b"t_fourth_comm", self.t_fourth_comm)
        z_challenge = transcript.challenge_scalar(b"z_challenge")
        for label, val in ((b"a_eval", ev.a_eval), (b"b_eval", ev.b_eval),
                           (b"c_eval", ev.c_eval), (b"d_eval", ev.d_eval),
                           (b"s_sigma_1_eval", ev.s_sigma_1_eval),
                           (b"s_sigma_2_eval", ev.s_sigma_2_eval),
                           (b"s_sigma_3_eval", ev.s_sigma_3_eval),
                           (b"z_eval", ev.z_eval),
                           (b"a_w_eval", ev.a_w_eval),
                           (b"b_w_eval", ev.b_w_eval),
                           (b"d_w_eval", ev.d_w_eval),
                           (b"q_arith_eval", ev.q_arith_eval),
                           (b"q_c_eval", ev.q_c_eval),
                           (b"q_l_eval", ev.q_l_eval),
                           (b"q_r_eval", ev.q_r_eval)):
            transcript.append_scalar(label, val)
        v_challenge = transcript.challenge_scalar(b"v_challenge")
        v_w_challenge = transcript.challenge_scalar(b"v_w_challenge")
        transcript.append_commitment(b"w_z_chall_comm", self.w_z_chall_comm)
        transcript.append_commitment(b"w_z_chall_w_comm", self.w_z_chall_w_comm)
        u_challenge = transcript.challenge_scalar(b"u_challenge")

        z_h_eval = domain.evaluate_vanishing_polynomial(z_challenge)
        l1_eval = compute_first_lagrange_evaluation(domain, z_h_eval,
                                                    z_challenge)
        lin_scalars, lin_points = self._linearization_terms(
            alpha, beta, gamma, (range_sep, logic_sep, fixed_sep, var_sep),
            z_challenge, u_challenge, l1_eval, verifier_key, domain)

        pi_eval = compute_barycentric_eval(pub_inputs, z_challenge, domain)
        r_0_eval = (pi_eval - l1_eval * alpha.square()
                    - alpha
                    * (ev.a_eval + beta * ev.s_sigma_1_eval + gamma)
                    * (ev.b_eval + beta * ev.s_sigma_2_eval + gamma)
                    * (ev.c_eval + beta * ev.s_sigma_3_eval + gamma)
                    * (ev.d_eval + gamma)
                    * ev.z_eval)

        v_coeffs = [v_challenge]
        for i in range(1, V_MAX_DEGREE):
            v_coeffs.append(v_coeffs[i - 1] * v_challenge)
        v_coeffs.append(v_w_challenge * u_challenge)
        v_coeffs.append(v_coeffs[V_MAX_DEGREE] * v_w_challenge)
        v_coeffs.append(v_coeffs[V_MAX_DEGREE + 1] * v_w_challenge)

        e_evals = [ev.a_eval, ev.b_eval, ev.c_eval, ev.d_eval,
                   ev.s_sigma_1_eval, ev.s_sigma_2_eval, ev.s_sigma_3_eval,
                   ev.a_w_eval, ev.b_w_eval, ev.d_w_eval]
        e_scalar = Fr.zero()
        for e, coeff in zip(e_evals, v_coeffs):
            e_scalar = e_scalar + e * coeff
        e_scalar = e_scalar + (-r_0_eval) + u_challenge * ev.z_eval

        msm_points = [self.a_comm.point, self.b_comm.point, self.c_comm.point,
                      self.d_comm.point,
                      verifier_key.permutation.s_sigma_1.point,
                      verifier_key.permutation.s_sigma_2.point,
                      verifier_key.permutation.s_sigma_3.point,
                      opening_key.g,
                      self.w_z_chall_w_comm.point,
                      self.w_z_chall_comm.point,
                      self.w_z_chall_w_comm.point]
        msm_scalars = list(v_coeffs[:V_MAX_DEGREE])
        msm_scalars[0] = msm_scalars[0] + v_coeffs[V_MAX_DEGREE]
        msm_scalars[1] = msm_scalars[1] + v_coeffs[V_MAX_DEGREE + 1]
        msm_scalars[3] = msm_scalars[3] + v_coeffs[V_MAX_DEGREE + 2]
        msm_scalars.append(e_scalar)
        msm_scalars.append(u_challenge)
        msm_scalars.append(z_challenge)
        msm_scalars.append(u_challenge * z_challenge * Fr(domain.group_gen))

        # the first V_MAX_DEGREE terms, e_commitment (negated) and the two
        # z-terms all fold into `right`, so they run as ONE pippenger MSM
        # (proof.rs:335-375 runs the same fold rayon-parallel per point)
        right_points = msm_points[:V_MAX_DEGREE] + [
            msm_points[V_MAX_DEGREE],      # g * (-e_scalar)
            msm_points[V_MAX_DEGREE + 2],  # w_z_chall * z
            msm_points[V_MAX_DEGREE + 3],  # w_z_chall_w * u*z*omega
        ]
        right_scalars = msm_scalars[:V_MAX_DEGREE] + [
            -msm_scalars[V_MAX_DEGREE],
            msm_scalars[V_MAX_DEGREE + 2],
            msm_scalars[V_MAX_DEGREE + 3],
        ]
        right = msm_host(right_points + lin_points,
                         right_scalars + lin_scalars).to_affine()
        left = (-msm_host(
            [self.w_z_chall_comm.point, msm_points[V_MAX_DEGREE + 1]],
            [Fr.one(), msm_scalars[V_MAX_DEGREE + 1]])).to_affine()
        from ..native import native_pairing_check

        live = [(p, q) for p, q in ((left, opening_key.x_h),
                                    (right, opening_key.h))
                if not p.is_identity()]
        ok = native_pairing_check(live) if live else True
        if ok is None:  # no native library: exact-int Python tower
            ok = final_exponentiation(multi_miller_loop([
                (left, opening_key.prepared_x_h),
                (right, opening_key.prepared_h)])) == Gt.identity()
        if not ok:
            raise ProofVerificationError()

    def _linearization_terms(self, alpha, beta, gamma, seps,
                             z_challenge, u_challenge, l1_eval,
                             verifier_key: VerifierKey,
                             domain: Domain):
        range_sep, logic_sep, fixed_sep, var_sep = seps
        scalars: list[Fr] = []
        points: list[G1Affine] = []
        ev = self.evaluations
        verifier_key.arithmetic.compute_linearization_commitment(
            scalars, points, ev)
        verifier_key.range.compute_linearization_commitment(
            range_sep, scalars, points, ev)
        verifier_key.logic.compute_linearization_commitment(
            logic_sep, scalars, points, ev)
        verifier_key.fixed_base.compute_linearization_commitment(
            fixed_sep, scalars, points, ev)
        verifier_key.variable_base.compute_linearization_commitment(
            var_sep, scalars, points, ev)
        verifier_key.permutation.compute_linearization_commitment(
            scalars, points, ev, z_challenge, u_challenge,
            (alpha, beta, gamma), l1_eval, self.z_comm.point)
        n = domain.size
        z_h_eval = -domain.evaluate_vanishing_polynomial(z_challenge)
        scalars.append(z_h_eval)
        points.append(self.t_low_comm.point)
        scalars.append(z_challenge.pow(n) * z_h_eval)
        points.append(self.t_mid_comm.point)
        scalars.append(z_challenge.pow(2 * n) * z_h_eval)
        points.append(self.t_high_comm.point)
        scalars.append(z_challenge.pow(3 * n) * z_h_eval)
        points.append(self.t_fourth_comm.point)
        return scalars, points


def compute_first_lagrange_evaluation(domain: Domain, z_h_eval: Fr,
                                      z_challenge: Fr) -> Fr:
    denom = Fr(domain.size) * (z_challenge - Fr.one())
    return z_h_eval * denom.invert()


def compute_barycentric_eval(evaluations: list[Fr], point: Fr,
                             domain: Domain) -> Fr:
    """Sparse barycentric evaluation with batch inversion (proof.rs:511-561)."""
    numerator = (point.pow(domain.size) - Fr.one()) * Fr(domain.size_inv)
    non_zero = [i for i, e in enumerate(evaluations) if not e.is_zero()]
    denominators = [
        (Fr(pow(domain.group_gen_inv, i, _Q)) * point - Fr.one()).value
        for i in non_zero]
    inverses = _batch_inverse(denominators, _Q)
    total = 0
    for idx, inv in zip(non_zero, inverses):
        total = (total + evaluations[idx].value * inv) % _Q
    return Fr(total) * numerator
