"""Device-resident polynomial helpers for the prover hot path.

Counterpart of `zkvm_tpu/plonk/dpoly.py`.  Wires, z, t and selectors live
across prover rounds as `[8, len]` int32 Montgomery tensors (limb-major),
and the only host round trips are the transcript scalars and commitment
points.  Every function that makes a tensor takes its device or works on
its operand's.

Key primitives (all exact mod-p integer math):

  * `powers_device`:  [1, z, z^2, ...] built with log2(m) doubling steps.
  * `eval_stack`:     batched Horner-free evaluation  p(z) = <coeffs, z^i>
                      via a pointwise multiply + binary reduction tree.
  * `ruffini_device`: synthetic division by (X - z) re-expressed as
                      q_i = z^-(i+1) * sum_{j>i} c_j z^j  -- a reversed
                      prefix sum instead of the serial recurrence
                      (fft/polynomial.rs:343).
  * `lin_comb`:       sum_i k_i * p_i with host-constant k_i.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import Fr
from ..ops import limb_field as lf
from ..ops.limb_field import FR

_Q = Fr.MODULUS


def to_device(values, size: int, device) -> torch.Tensor:
    """Host Fr/int list -> [8, size] Montgomery tensor (zero-padded)."""
    vals = [v.value if isinstance(v, Fr) else int(v) for v in values]
    assert len(vals) <= size
    return FR.to_mont_array(vals + [0] * (size - len(vals)), device)


def from_device(tensor: torch.Tensor) -> list[Fr]:
    """[8, m] Montgomery tensor -> host Fr list."""
    return [Fr(v) for v in FR.from_mont_array(tensor)]


def const_col(value: int, device) -> torch.Tensor:
    """[8, 1] Montgomery column for a host scalar."""
    return lf.u32_to_tensor(FR.mont_limbs(value % _Q)[:, None], device)


def powers_device(z_col: torch.Tensor, m: int) -> torch.Tensor:
    """[8, m] table of z^0 .. z^(m-1) (log2 m Montgomery doubling steps)."""
    out = const_col(1, z_col.device)
    p = z_col
    while out.shape[-1] < m:
        nxt = lf.mont_mul(FR, out, p.expand(out.shape))
        out = torch.cat([out, nxt], dim=-1)
        p = lf.mont_mul(FR, p, p)
    return out[:, :m].contiguous()


def _eval_stack_impl(stack: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """stack [S, 8, m] * pw [8, m] summed over lanes -> [S, 8, 1]."""
    t = lf.mont_mul(FR, stack, pw.expand(stack.shape))
    m = t.shape[-1]
    while m > 1:
        if m % 2:
            t = F.pad(t, (0, 1))
            m += 1
        m //= 2
        t = lf.add(FR, t[..., :m], t[..., m:])
    return t


def eval_stack(stack: torch.Tensor, z: Fr) -> list[Fr]:
    """Evaluate S stacked polynomials [S, 8, m] at z; returns S host Fr."""
    pw = powers_device(const_col(z.value, stack.device), stack.shape[-1])
    out = _eval_stack_impl(stack, pw)
    return from_device(out[..., 0].T)


def _scan(t: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of the field operation `op` over the last axis of
    [8, m].  Log depth: combine adjacent pairs, scan the half-length array
    (the odd lanes), then one more `op` fixes the even lanes -- about 2m
    operations in 2 log2(m) steps.  Sums and products mod r are exact, so
    the grouping does not show in the result."""
    m = t.shape[-1]
    if m <= 1:
        return t
    odd = _scan(op(t[..., 0:m - 1:2], t[..., 1::2]), op)
    out = torch.empty_like(t)
    out[..., 0:1] = t[..., 0:1]
    out[..., 1::2] = odd
    k = (m - 1) // 2  # even lanes after lane 0
    if k:
        out[..., 2::2] = op(odd[..., :k], t[..., 2::2])
    return out


def _suffix_sums(t: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums mod r over the last axis of [8, m]."""
    return _scan(t.flip(-1), lambda a, b: lf.add(FR, a, b)).flip(-1)


def prefix_products(t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (suffix when `reverse`) Montgomery products over the
    last axis of [8, m] (the counterpart of the reference's
    `jax.lax.associative_scan(mul, ...)`)."""
    mul = lambda a, b: lf.mont_mul(FR, a, b)  # noqa: E731
    if reverse:
        return _scan(t.flip(-1), mul).flip(-1)
    return _scan(t, mul)


def _ruffini_impl(coeffs: torch.Tensor, pw: torch.Tensor,
                  ipw: torch.Tensor) -> torch.Tensor:
    suf = _suffix_sums(lf.mont_mul(FR, coeffs, pw))
    # q_i = z^-(i+1) * suffix_{i+1},  i = 0..m-2
    return lf.mont_mul(FR, suf[:, 1:], ipw)


def ruffini_device(coeffs: torch.Tensor, z: Fr) -> torch.Tensor:
    """[8, m] coeffs -> [8, m-1] quotient of division by (X - z).

    z == 0 is the degenerate case q_i = c_{i+1} (Fiat-Shamir challenges
    never are zero)."""
    m = coeffs.shape[-1]
    if z.is_zero():
        return coeffs[:, 1:]
    dev = coeffs.device
    pw = powers_device(const_col(z.value, dev), m)
    inv_z = pow(z.value, -1, _Q)
    ipw = lf.mont_mul_const(FR, powers_device(const_col(inv_z, dev), m - 1),
                            FR.mont_limbs(inv_z))
    return _ruffini_impl(coeffs, pw, ipw)


def lin_comb(tensors_and_scalars, size: int, device) -> torch.Tensor:
    """sum_i k_i * p_i over device tensors with host Fr scalars k_i.

    Tensors may have different lengths; all are padded to `size`.  `device`
    is where the zero polynomial of an empty sum is made."""
    acc = None
    for tensor, k in tensors_and_scalars:
        kv = k.value if isinstance(k, Fr) else int(k) % _Q
        if kv == 0:
            continue
        t = F.pad(tensor, (0, size - tensor.shape[-1]))
        term = t if kv == 1 else lf.mont_mul_const(FR, t, FR.mont_limbs(kv))
        acc = term if acc is None else lf.add(FR, acc, term)
    if acc is None:
        return torch.zeros((FR.n_limbs, size), dtype=torch.int32,
                           device=device)
    return acc


def apply_blinders_device(rng, coeffs: torch.Tensor,
                          hiding_degree: int) -> torch.Tensor:
    """Device analogue of the reference's blind_poly tail
    (compiler/prover.rs:64-83): coeffs[i] -= b_i and append b_i, drawing
    blinders in the exact same rng order as the host path."""
    blinders = [Fr.random(rng) for _ in range(hiding_degree + 1)]
    b_col = to_device(blinders, hiding_degree + 1, coeffs.device)
    low = lf.sub(FR, coeffs[:, : hiding_degree + 1], b_col)
    return torch.cat([low, coeffs[:, hiding_degree + 1:], b_col], dim=-1)
