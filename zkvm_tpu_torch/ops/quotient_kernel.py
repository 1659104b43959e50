"""Device evaluation of the PLONK quotient numerator.

Mirrors the pointwise gate + permutation terms of
plonk/src/proof_system/quotient_poly.rs:102-236 and the per-widget
compute_quotient_i formulas (proof_system/widget/*/proverkey.rs), evaluated
over the whole 8n coset domain on [8, 8n] limb tensors.  Challenges enter as
[8, 1] Montgomery columns.

Counterpart of `zkvm_tpu/ops/quotient_kernel.py`, the same formulas in the
same order.  There `jit` fuses the whole numerator into one program; here it
is plain calls of `lf.mont_mul` and of `lf.add` / `lf.sub` (the mont_mul and
field_addsub kernels on the card), each of which reads an [8, 1] column or
a broadcast operand in place: nothing of the full width is made for one.
"""

from __future__ import annotations

import functools

import torch

from .. import params
from . import limb_field as lf
from .limb_field import FR

_Q = params.FR_MODULUS


@functools.lru_cache(maxsize=None)
def _column(v: int, device: torch.device) -> torch.Tensor:
    """[8, 1] Montgomery column of a small host constant on `device`."""
    return lf.u32_to_tensor(FR.mont_limbs(v % _Q)[:, None], device)


def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    return _column(v, like.device)


def _mulc(a, v: int):
    return lf.mont_mul(FR, a, _const(v, a))


def _mul(a, b):
    return lf.mont_mul(FR, a, b)


def _add(a, b):
    return lf.add(FR, a, b)


def _sub(a, b):
    return lf.sub(FR, a, b)


def _delta(f):
    """f(f-1)(f-2)(f-3) (range/logic widget delta)."""
    t = _mul(f, _sub(f, _const(1, f)))
    t = _mul(t, _sub(f, _const(2, f)))
    return _mul(t, _sub(f, _const(3, f)))


def _delta_xor_and(a, b, w, c, q_c):
    """Choice polynomial (logic/proverkey.rs delta_xor_and)."""
    sum_ab = _add(a, b)
    inner = _add(_sub(_mulc(w, 4), _mulc(sum_ab, 18)), _const(81, w))
    sq = _add(_mul(a, a), _mul(b, b))
    f = _mul(w, _add(_sub(_add(_mul(w, inner), _mulc(sq, 18)),
                          _mulc(sum_ab, 81)),
                     _const(83, w)))
    e = _sub(_mulc(_add(sum_ab, c), 3), _mulc(f, 2))
    bb = _mul(q_c, _sub(_mulc(c, 9), _mulc(sum_ab, 3)))
    return _add(bb, e)


def quotient_numerator(sel, wires, z, z_w, pi, l1_alpha_sq, linear, chals):
    """Numerator of the quotient over the 8n coset.

    sel: dict of selector/sigma eval tensors [L, 8n]
    wires: (a, b, c, d, a_w, b_w, d_w); z/z_w: grand product (+shift)
    pi: public-input evals; l1_alpha_sq: L1*alpha^2 evals
    linear: X evals over the coset; chals: dict of challenge columns [8, 1]
    (read in place by every kernel, never expanded)
    """
    a, b, c, d, a_w, b_w, d_w = wires
    alpha, beta, gamma = chals["alpha"], chals["beta"], chals["gamma"]

    # -- arithmetic (widget/arithmetic/proverkey.rs:43-66) --------------------
    t_arith = _add(_mul(_mul(a, b), sel["q_m"]), _mul(a, sel["q_l"]))
    t_arith = _add(t_arith, _mul(b, sel["q_r"]))
    t_arith = _add(t_arith, _mul(c, sel["q_o"]))
    t_arith = _add(t_arith, _mul(d, sel["q_f"]))
    t_arith = _add(t_arith, sel["q_c"])
    total = _mul(t_arith, sel["q_arith"])

    # -- range (widget/range/proverkey.rs:31-66) -------------------------------
    r_sep = chals["range_sep"]
    kappa = _mul(r_sep, r_sep)
    k2 = _mul(kappa, kappa)
    k3 = _mul(k2, kappa)
    rng = _delta(_sub(c, _mulc(d, 4)))
    rng = _add(rng, _mul(_delta(_sub(b, _mulc(c, 4))), kappa))
    rng = _add(rng, _mul(_delta(_sub(a, _mulc(b, 4))), k2))
    rng = _add(rng, _mul(_delta(_sub(d_w, _mulc(a, 4))), k3))
    total = _add(total, _mul(_mul(rng, sel["q_range"]), r_sep))

    # -- logic (widget/logic/proverkey.rs:34-103) ------------------------------
    l_sep = chals["logic_sep"]
    kappa = _mul(l_sep, l_sep)
    k2 = _mul(kappa, kappa)
    k3 = _mul(k2, kappa)
    k4 = _mul(k3, kappa)
    a_sd = _sub(a_w, _mulc(a, 4))
    b_sd = _sub(b_w, _mulc(b, 4))
    d_sd = _sub(d_w, _mulc(d, 4))
    lg = _delta(a_sd)
    lg = _add(lg, _mul(_delta(b_sd), kappa))
    lg = _add(lg, _mul(_delta(d_sd), k2))
    lg = _add(lg, _mul(_sub(c, _mul(a_sd, b_sd)), k3))
    lg = _add(lg, _mul(_delta_xor_and(a_sd, b_sd, c, d_sd, sel["q_c"]),
                       k4))
    total = _add(total, _mul(_mul(sel["q_logic"], lg), l_sep))

    # -- fixed-base ECC (widget/ecc/scalar_mul/fixed_base/proverkey.rs:30-110) --
    f_sep = chals["fixed_sep"]
    kappa = _mul(f_sep, f_sep)
    k2 = _mul(kappa, kappa)
    k3 = _mul(k2, kappa)
    x_beta, y_beta = sel["q_l"], sel["q_r"]
    bit = _sub(_sub(d_w, d), d)
    one = _const(1, a)
    bit_consistency = _mul(_mul(bit, _sub(bit, one)), _add(bit, one))
    y_alpha = _add(_mul(_mul(bit, bit), _sub(y_beta, one)), one)
    x_alpha = _mul(bit, x_beta)
    xy_consistency = _mul(_sub(_mul(bit, sel["q_c"]), c), kappa)
    exd = _mulc(_mul(a, b), params.JUBJUB_D)
    x_lhs = _add(a_w, _mul(_mul(a_w, c), exd))
    x_rhs = _add(_mul(a, y_alpha), _mul(b, x_alpha))
    x_acc = _mul(_sub(x_lhs, x_rhs), k2)
    y_lhs = _sub(b_w, _mul(_mul(b_w, c), exd))
    y_rhs = _add(_mul(b, y_alpha), _mul(a, x_alpha))
    y_acc = _mul(_sub(y_lhs, y_rhs), k3)
    fixed = _add(_add(bit_consistency, x_acc), _add(y_acc, xy_consistency))
    total = _add(total, _mul(_mul(fixed, sel["q_fixed_group_add"]),
                             f_sep))

    # -- variable-base ECC (widget/ecc/curve_addition/proverkey.rs:31-90) ------
    v_sep = chals["var_sep"]
    kappa = _mul(v_sep, v_sep)
    x1, x3, y1, y3 = a, a_w, b, b_w
    x2, y2, x1y2 = c, d, d_w
    xy_consistency = _sub(_mul(x1, y2), x1y2)
    y1x2 = _mul(y1, x2)
    mix = _mulc(_mul(x1y2, y1x2), params.JUBJUB_D)
    x3_lhs = _add(x1y2, y1x2)
    x3_rhs = _add(x3, _mul(x3, mix))
    x3_c = _mul(_sub(x3_lhs, x3_rhs), kappa)
    y3_lhs = _add(_mul(y1, y2), _mul(x1, x2))
    y3_rhs = _sub(y3, _mul(y3, mix))
    y3_c = _mul(_sub(y3_lhs, y3_rhs), _mul(kappa, kappa))
    var = _add(xy_consistency, _add(x3_c, y3_c))
    total = _add(total, _mul(_mul(var, sel["q_variable_group_add"]),
                             v_sep))

    # -- public inputs ----------------------------------------------------------
    total = _add(total, pi)

    # -- permutation (widget/permutation/proverkey.rs:31-140) -------------------
    bx = _mul(beta, linear)
    identity = _mul(_add(_add(a, bx), gamma),
                    _add(_add(b, _mulc(bx, params.K1)), gamma))
    identity = _mul(identity, _add(_add(c, _mulc(bx, params.K2)),
                                   gamma))
    identity = _mul(identity, _add(_add(d, _mulc(bx, params.K3)),
                                   gamma))
    identity = _mul(_mul(identity, z), alpha)
    copy = _mul(_add(_add(a, _mul(beta, sel["s_sigma_1"])),
                     gamma),
                _add(_add(b, _mul(beta, sel["s_sigma_2"])),
                     gamma))
    copy = _mul(copy, _add(_add(c, _mul(beta, sel["s_sigma_3"])),
                           gamma))
    copy = _mul(copy, _add(_add(d, _mul(beta, sel["s_sigma_4"])),
                           gamma))
    copy = _mul(_mul(copy, z_w), alpha)
    one_check = _mul(_sub(z, one), l1_alpha_sq)
    total = _add(total, _add(_sub(identity, copy), one_check))
    return total


def pointwise_divide(numerator, v_h_inv):
    """quotient = numerator * Z_H^-1 pointwise (quotient_poly.rs:86-95)."""
    return lf.mont_mul(FR, numerator, v_h_inv)
