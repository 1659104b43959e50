"""A PLONK verifier that knows the setup's trapdoor (dusk-plonk proof.rs).

It replays the proof's transcript against a verifier key that the
reference built itself (`circuit.verifier_key`), forms the two points
that the reference's final pairing check compares, left = -(W_z + u W_zw)
and right (the linearization, the opening terms and -e g), and accepts
exactly when [tau] left + right = 0, which is that pairing equation with
x_h = [tau] h.  The linearization holds every widget of dusk-plonk's
`proof_system/widget`: arithmetic, permutation, and the range, logic,
fixed-base and variable-base (curve addition) families, each family's
identity at the evaluations scaled by its separation challenge and
committed by its selector.  A family that no gate uses commits to the
identity and its term drops out.
"""

from __future__ import annotations

from . import curve, jubjub
from .circuit import domain_size
from .field import K1, K2, K3, R, root_of_unity, scalar_from_bytes
from .transcript import Transcript

COMMITMENTS = ("a", "b", "c", "d", "z", "t_low", "t_mid", "t_high",
               "t_fourth", "w_z", "w_zw")
EVALUATIONS = ("a", "b", "c", "d", "a_w", "b_w", "d_w", "q_arith", "q_c",
               "q_l", "q_r", "s_sigma_1", "s_sigma_2", "s_sigma_3", "z")
PROOF_SIZE = 48 * len(COMMITMENTS) + 32 * len(EVALUATIONS)
SEPARATIONS = (b"range separation challenge", b"logic separation challenge",
               b"fixed base separation challenge",
               b"variable base separation challenge")
# VerifierKey::seed_transcript's order, s_sigma_1 again under "s_sigma_4"
SEED_ORDER = (("q_m", "q_m"), ("q_l", "q_l"), ("q_r", "q_r"),
              ("q_o", "q_o"), ("q_c", "q_c"), ("q_f", "q_f"),
              ("q_arith", "q_arith"), ("q_range", "q_range"),
              ("q_logic", "q_logic"),
              ("q_variable_group_add", "q_variable_group_add"),
              ("q_fixed_group_add", "q_fixed_group_add"),
              ("s_sigma_1", "s_sigma_1"), ("s_sigma_2", "s_sigma_2"),
              ("s_sigma_3", "s_sigma_3"), ("s_sigma_4", "s_sigma_1"))


class Rejected(ValueError):
    """The proof does not verify; the message says where it failed."""


def parse_proof(buf: bytes):
    """(commitments: name -> (point, encoding), evaluations: name -> int)."""
    if len(buf) != PROOF_SIZE:
        raise Rejected(f"proof is {len(buf)} bytes, not {PROOF_SIZE}")
    comms = {}
    for i, name in enumerate(COMMITMENTS):
        enc = bytes(buf[48 * i: 48 * (i + 1)])
        try:
            comms[name] = (curve.from_bytes(enc), enc)
        except ValueError as err:
            raise Rejected(f"{name}_comm: {err}") from None
    evals = {}
    base = 48 * len(COMMITMENTS)
    for i, name in enumerate(EVALUATIONS):
        v = scalar_from_bytes(bytes(buf[base + 32 * i: base + 32 * (i + 1)]))
        if v is None:
            raise Rejected(f"{name}_eval is not below r")
        evals[name] = v
    return comms, evals


def delta(f: int) -> int:
    """f (f - 1) (f - 2) (f - 3): zero exactly on a base-4 digit."""
    return f * (f - 1) % R * (f - 2) % R * (f - 3) % R


def delta_xor_and(a: int, b: int, w: int, c: int, q_c: int) -> int:
    """logic/proverkey.rs: zero where c is a AND b (q_c = 1) or a XOR b
    (q_c = -1) of the digits a, b whose product is w."""
    f = w * (w * (4 * w - 18 * (a + b) + 81)
             + 18 * (a * a + b * b) - 81 * (a + b) + 83) % R
    e = (3 * (a + b + c) - 2 * f) % R
    return (q_c * (9 * c - 3 * (a + b)) + e) % R


def range_term(sep: int, ev) -> int:
    """range/verifierkey.rs: the four base-4 digits of a gate, d -> c ->
    b -> a -> the next row's d."""
    kappa = sep * sep % R
    a, b, c, d = ev["a"], ev["b"], ev["c"], ev["d"]
    t = 0
    for k, digit in enumerate((c - 4 * d, b - 4 * c, a - 4 * b,
                               ev["d_w"] - 4 * a)):
        t += delta(digit % R) * pow(kappa, k, R)
    return t % R * sep % R


def logic_term(sep: int, ev) -> int:
    """logic/verifierkey.rs: the digits of a, b and the output taken from
    the accumulators (next row - 4 this row), c their product, the output
    digit the AND or XOR the sign of q_c chooses."""
    kappa = sep * sep % R
    a = (ev["a_w"] - 4 * ev["a"]) % R
    b = (ev["b_w"] - 4 * ev["b"]) % R
    d = (ev["d_w"] - 4 * ev["d"]) % R
    w = ev["c"]
    terms = (delta(a), delta(b), delta(d), (w - a * b) % R,
             delta_xor_and(a, b, w, d, ev["q_c"]))
    return sum(t * pow(kappa, k, R) for k, t in enumerate(terms)) % R * sep % R


def fixed_base_term(sep: int, ev) -> int:
    """scalar_mul/fixed_base/verifierkey.rs: the accumulator (a, b) -> (a_w,
    b_w) adds bit * (q_l, q_r) (bit = d_w - 2 d in {-1, 0, 1}, the WNAF
    digit), with c = x_alpha y_alpha = bit q_c."""
    kappa = sep * sep % R
    acc_x, acc_y = ev["a"], ev["b"]
    x3, y3 = ev["a_w"], ev["b_w"]
    xy_alpha = ev["c"]
    bit = (ev["d_w"] - 2 * ev["d"]) % R
    bit_consistency = bit * (bit - 1) % R * (bit + 1) % R
    y_alpha = (bit * bit % R * (ev["q_r"] - 1) + 1) % R
    x_alpha = bit * ev["q_l"] % R
    xy_consistency = (bit * ev["q_c"] - xy_alpha) % R
    dxy = xy_alpha * acc_x % R * acc_y % R * jubjub.D % R
    x_acc = (x3 + x3 * dxy - (x_alpha * acc_y + y_alpha * acc_x)) % R
    y_acc = (y3 - y3 * dxy - (x_alpha * acc_x + y_alpha * acc_y)) % R
    t = (bit_consistency + xy_consistency * kappa
         + x_acc * kappa % R * kappa + y_acc * pow(kappa, 3, R))
    return t % R * sep % R


def variable_base_term(sep: int, ev) -> int:
    """ecc/curve_addition/verifierkey.rs: (a_w, b_w) = (a, b) + (c, d) on
    JubJub, with d_w = a d."""
    kappa = sep * sep % R
    x1, y1, x2, y2 = ev["a"], ev["b"], ev["c"], ev["d"]
    x3, y3, x1y2 = ev["a_w"], ev["b_w"], ev["d_w"]
    y1x2 = y1 * x2 % R
    mix = jubjub.D * x1y2 % R * y1x2 % R
    xy_consistency = x1 * y2 - x1y2
    x3_consistency = x1y2 + y1x2 - (x3 + x3 * mix)
    y3_consistency = y1 * y2 + x1 * x2 - (y3 - y3 * mix)
    t = (xy_consistency + x3_consistency * kappa
         + y3_consistency * kappa % R * kappa)
    return t % R * sep % R


WIDGETS = ((range_term, "q_range"), (logic_term, "q_logic"),
           (fixed_base_term, "q_fixed_group_add"),
           (variable_base_term, "q_variable_group_add"))


def base_transcript(label: bytes, vk) -> Transcript:
    t = Transcript(label)
    t.circuit_domain_sep(vk["n"])
    for label_name, key in SEED_ORDER:
        t.append_commitment(label_name.encode(), curve.to_bytes(vk[key]))
    t.circuit_domain_sep(vk["n"])
    return t


def verify(proof_bytes: bytes, public: dict[int, int], vk, label: bytes,
           tau: int, g) -> None:
    """Raise `Rejected` unless the proof verifies; `public` maps a gate
    index to its public input value."""
    comms, ev = parse_proof(proof_bytes)
    pt = {name: p for name, (p, _) in comms.items()}
    n = domain_size(vk["n"])
    omega = root_of_unity(n)
    t = base_transcript(label, vk)
    for idx in sorted(public):
        t.append_scalar(b"pi", public[idx])

    for name in ("a", "b", "c", "d"):
        t.append_commitment(f"{name}_comm".encode(), comms[name][1])
    beta = t.challenge_scalar(b"beta")
    t.append_scalar(b"beta", beta)
    gamma = t.challenge_scalar(b"gamma")
    t.append_commitment(b"z_comm", comms["z"][1])
    alpha = t.challenge_scalar(b"alpha")
    seps = [t.challenge_scalar(label) for label in SEPARATIONS]
    for name in ("t_low", "t_mid", "t_high", "t_fourth"):
        t.append_commitment(f"{name}_comm".encode(), comms[name][1])
    z = t.challenge_scalar(b"z_challenge")
    for name in ("a", "b", "c", "d", "s_sigma_1", "s_sigma_2", "s_sigma_3",
                 "z", "a_w", "b_w", "d_w", "q_arith", "q_c", "q_l", "q_r"):
        t.append_scalar(f"{name}_eval".encode(), ev[name])
    v = t.challenge_scalar(b"v_challenge")
    v_w = t.challenge_scalar(b"v_w_challenge")
    t.append_commitment(b"w_z_chall_comm", comms["w_z"][1])
    t.append_commitment(b"w_z_chall_w_comm", comms["w_zw"][1])
    u = t.challenge_scalar(b"u_challenge")

    zn = pow(z, n, R)
    z_h = (zn - 1) % R
    l1 = z_h * pow(n * (z - 1) % R, -1, R) % R
    # sparse barycentric evaluation of the public inputs at z
    pi_eval = 0
    for idx, value in public.items():
        if value:
            pi_eval += value * pow((pow(omega, -idx, R) * z - 1) % R, -1, R)
    pi_eval = pi_eval % R * z_h % R * pow(n, -1, R) % R

    a, b, c, d = ev["a"], ev["b"], ev["c"], ev["d"]
    s1, s2, s3, z_eval = ev["s_sigma_1"], ev["s_sigma_2"], ev["s_sigma_3"], ev["z"]
    qa = ev["q_arith"]
    alpha_sq = alpha * alpha % R
    # linearization: arithmetic, the four gate families, permutation,
    # quotient chunks
    lin = [(a * b % R * qa, vk["q_m"]), (a * qa, vk["q_l"]),
           (b * qa, vk["q_r"]), (c * qa, vk["q_o"]), (d * qa, vk["q_f"]),
           (qa, vk["q_c"])]
    lin += [(term(sep, ev), vk[name])
            for sep, (term, name) in zip(seps, WIDGETS)]
    bz = beta * z % R
    identity = ((a + bz + gamma) * (b + K1 * bz + gamma) % R
                * (c + K2 * bz + gamma) % R * (d + K3 * bz + gamma) % R
                * alpha % R)
    lin.append(((identity + l1 * alpha_sq + u) % R, pt["z"]))
    copy = ((a + beta * s1 + gamma) * (b + beta * s2 + gamma) % R
            * (c + beta * s3 + gamma) % R * (beta * z_eval % R) % R
            * alpha % R)
    lin.append((-copy % R, vk["s_sigma_4"]))
    neg_zh = -z_h % R
    for k, name in enumerate(("t_low", "t_mid", "t_high", "t_fourth")):
        lin.append((pow(zn, k, R) * neg_zh % R, pt[name]))

    r0 = (pi_eval - l1 * alpha_sq
          - alpha * (a + beta * s1 + gamma) % R * (b + beta * s2 + gamma) % R
          * (c + beta * s3 + gamma) % R * (d + gamma) % R * z_eval) % R
    vs = [v]
    for _ in range(6):
        vs.append(vs[-1] * v % R)
    vw = [v_w * u % R]
    for _ in range(2):
        vw.append(vw[-1] * v_w % R)
    e = sum(x * k for x, k in zip(
        (a, b, c, d, s1, s2, s3, ev["a_w"], ev["b_w"], ev["d_w"]), vs + vw))
    e = (e - r0 + u * z_eval) % R
    opening = list(vs)
    opening[0] += vw[0]
    opening[1] += vw[1]
    opening[3] += vw[2]
    right_terms = list(zip(opening, (pt["a"], pt["b"], pt["c"], pt["d"],
                                     vk["s_sigma_1"], vk["s_sigma_2"],
                                     vk["s_sigma_3"])))
    right_terms += [(-e % R, g), (z, pt["w_z"]),
                    (u * z % R * omega % R, pt["w_zw"])]
    right_terms += lin
    live = [(k, p) for k, p in right_terms if p is not None]
    right = curve.lincomb([p for _, p in live], [k for k, _ in live])
    left = curve.neg(curve.add(pt["w_z"], curve.mul(pt["w_zw"], u)))
    if curve.add(curve.mul(left, tau), right) is not None:
        raise Rejected("the opening check fails")
