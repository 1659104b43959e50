"""Quotient polynomial builder (plonk/src/proof_system/quotient_poly.rs).

The hot loop -- pointwise gate + permutation terms over the 8n coset domain,
divided by the vanishing polynomial -- runs fully on the device
(`zkvm_tpu_torch/ops/quotient_kernel.py`) over [8, 8n] limb tensors: one
batched coset FFT in, the numerator and the pointwise multiply by the
precomputed Z_H^-1 in one launch of the quotient kernel
(`csrc/quotient.cu`), a coset iFFT out.  Selector/sigma coset evaluations are
cached on the ProverKey, per device, after the first proof.

Counterpart of `zkvm_tpu/plonk/quotient.py`.  Every transform is a `Domain`
method, or on a mesh a `DistributedDomain` one.  The seven polynomials
taken to the coset (a, b, c, d, z, PI and L1 alpha^2) go in ONE batched
transform, as the reference's prover round 3 does; the values are those of
the reference's separate transforms.  On a mesh the numerator and the
division run shard by shard on each shard's slice of the 8n evaluation
axis (the reference's `shard_map` pointwise step); the shifted evaluations
are rolled on the global tensors, before the split, since the roll wraps
across the whole axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import Fr
from ..ops import quotient_kernel as qk
from ..ops.limb_field import FR
from ..ops.ntt import Domain, _batch_inverse
from ..ops.ntt_sharded import DistributedDomain
from . import dpoly
from .polynomial import Polynomial
from .widgets import ProverKey

_Q = Fr.MODULUS

_SELECTOR_PAIRS = (("arithmetic", "q_m"), ("arithmetic", "q_l"),
                   ("arithmetic", "q_r"), ("arithmetic", "q_o"),
                   ("arithmetic", "q_f"), ("arithmetic", "q_c"),
                   ("arithmetic", "q_arith"), ("range", "q_range"),
                   ("logic", "q_logic"),
                   ("fixed_base", "q_fixed_group_add"),
                   ("variable_base", "q_variable_group_add"),
                   ("permutation", "s_sigma_1"), ("permutation", "s_sigma_2"),
                   ("permutation", "s_sigma_3"), ("permutation", "s_sigma_4"))


def _device_cache(pk: ProverKey, device):
    """Device-resident selector/sigma/Z_H^-1/linear tensors on `device`
    (built once per device; the compiler leaves the ones it made)."""
    device = torch.device(device)
    caches = pk.__dict__.setdefault("_device_cache", {})
    cache = caches.get(device)
    if cache is not None:
        return cache
    sel = {}
    for fam, name in _SELECTOR_PAIRS:
        evals = getattr(getattr(pk, fam), name)[1]
        sel[name] = FR.to_mont_array([e.value for e in evals.evals], device)
    v_h_inv = FR.to_mont_array(
        _batch_inverse([e.value for e in pk.v_h_coset_8n.evals], _Q), device)
    linear = FR.to_mont_array(
        [e.value for e in pk.permutation.linear_evaluations.evals], device)
    cache = caches[device] = (sel, v_h_inv, linear)
    return cache


def _mesh_cache(pk: ProverKey, mesh):
    """Each shard's slice of the selector/sigma, Z_H^-1 and linear tables
    on its device (a view where that is the home device), built once per
    key and mesh."""
    caches = pk.__dict__.setdefault("_mesh_cache", {})
    cache = caches.get(mesh)
    if cache is None:
        sel, v_h_inv, linear = _device_cache(pk, mesh.home)
        parts = {name: mesh.split(t) for name, t in sel.items()}
        cache = caches[mesh] = [
            ({name: p[i] for name, p in parts.items()}, vh, lin)
            for i, (vh, lin) in enumerate(zip(mesh.split(v_h_inv),
                                              mesh.split(linear)))]
    return cache


def _to_device_coeffs(poly: Polynomial, size: int, device) -> torch.Tensor:
    vals = [c.value for c in poly.coeffs]
    vals += [0] * (size - len(vals))
    return FR.to_mont_array(vals, device)


def build_quotient_device(domain: Domain, prover_key: ProverKey,
                          z_dev, wires_dev, pi_dev, challenges,
                          mesh=None, axis: str | None = None):
    """Device-resident quotient: [8, len] Montgomery coefficient tensors in,
    [8, 8n] quotient coefficients out, on their device -- no host
    conversion anywhere.

    With `mesh` (whose home holds the tensors), the transforms run as
    distributed 4-step NTTs and the numerator and the division shard over
    the evaluation axis -- the multi-chip replacement for the rayon hot
    loop at quotient_poly.rs:86-95."""
    (alpha, beta, gamma, range_ch, logic_ch, fixed_ch, var_ch) = challenges
    n = domain.size
    size_8n = 8 * n
    dev = z_dev.device
    if mesh is None:
        dom, dom_8n = domain, Domain(size_8n)
    else:
        dom = DistributedDomain(n, mesh, axis)
        dom_8n = DistributedDomain(size_8n, mesh, axis)

    # L1 * alpha^2 (quotient_poly.rs:195-236), coefficients of degree < n
    alpha_sq = alpha.value * alpha.value % _Q
    l1_coeffs = dom.ifft_device(dpoly.to_device([alpha_sq], n, dev))

    # ONE batched coset FFT for all seven polynomials (a, b, c, d, z, PI, L1)
    polys = tuple(wires_dev) + (z_dev, pi_dev, l1_coeffs)
    stacked = torch.stack([F.pad(p, (0, size_8n - p.shape[-1]))
                           for p in polys])  # [7, 8, 8n]
    a8, b8, c8, d8, z8, pi8, l1_8n = dom_8n.coset_fft_device(
        stacked).unbind(0)
    # shifted (X*omega) accesses: +8 with wrap-around == roll by -8
    # (quotient_poly.rs:46-59), over the whole global axis
    a8w, b8w, d8w, z8w = (torch.roll(t, -8, dims=-1)
                          for t in (a8, b8, d8, z8))

    chals = {name: c.value for name, c in zip(qk.CHALLENGES, challenges)}
    evals = (a8, b8, c8, d8, a8w, b8w, d8w, z8, z8w, pi8, l1_8n)
    if mesh is None:
        sel, v_h_inv, linear = _device_cache(prover_key, dev)
        quotient = _pointwise(sel, evals, linear, v_h_inv, chals)
    else:
        shards = zip(_mesh_cache(prover_key, mesh),
                     *(mesh.split(t) for t in evals))
        quotient = mesh.gather([
            _pointwise(sel, ev, lin, vh, chals)
            for (sel, vh, lin), *ev in shards])
    return dom_8n.coset_ifft_device(quotient)  # [8, 8n] coefficients


def _pointwise(sel, evals, linear, v_h_inv, chals):
    """Numerator over (a slice of) the 8n coset, divided by Z_H: one
    launch of the quotient kernel on the card."""
    a8, b8, c8, d8, a8w, b8w, d8w, z8, z8w, pi8, l1_8n = evals
    return qk.quotient_pointwise(
        sel, (a8, b8, c8, d8, a8w, b8w, d8w), z8, z8w, pi8, l1_8n, linear,
        v_h_inv, chals)


def build_quotient_polynomial(domain: Domain, prover_key: ProverKey,
                              z_poly: Polynomial, wires, pi_poly: Polynomial,
                              challenges, device) -> Polynomial:
    """Host-Polynomial wrapper around build_quotient_device."""
    def dev(p):
        vals = [c.value for c in p.coeffs]
        return FR.to_mont_array(vals if vals else [0], device)

    coeffs = build_quotient_device(
        domain, prover_key, dev(z_poly), tuple(dev(w) for w in wires),
        dev(pi_poly), challenges)
    return Polynomial([Fr(v) for v in FR.from_mont_array(coeffs)])
