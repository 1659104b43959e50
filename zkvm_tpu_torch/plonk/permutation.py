"""Copy-constraint permutation argument (plonk/src/composer/permutation.rs).

Builds the four sigma cycle mappings from witness wire usage, converts them
to Lagrange-basis polynomials over the cosets {1, K1, K2, K3}*H, and computes
the grand-product accumulator z.  Cycle construction stays host-side (tiny,
pointer-chasing); the grand product over the full domain is a prefix scan --
device offload happens in the prover once wire vectors are device-resident.

Counterpart of `zkvm_tpu/plonk/permutation.py`: the host half is a copy
(the two host transforms take the device they run on), the device half is
ported, with `jax.lax.associative_scan` of the Montgomery product replaced
by the log-depth scan `dpoly.prefix_products`, or on a mesh by
`collective.sharded_scan_mul`.  The product mod r is exact, so the grouping
of the products changes no bit.
"""

from __future__ import annotations

import torch

from .. import params
from ..fields import Fr
from ..ops import limb_field as lf
from ..ops.collective import sharded_scan_mul
from ..ops.limb_field import FR
from ..ops.ntt import Domain, _batch_inverse
from . import dpoly
from .constraint_system import Witness, WireData
from .polynomial import Polynomial

_Q = Fr.MODULUS

K1 = Fr(params.K1)
K2 = Fr(params.K2)
K3 = Fr(params.K3)


class Permutation:
    """Witness -> wire-usage map (permutation.rs:16-74)."""

    def __init__(self):
        # dense witness indices -> wire-usage lists (a list outruns the
        # round-2 dict: no Witness hashing on the synthesis hot path)
        self.witness_map: list[list[WireData]] = []

    def new_witness(self) -> Witness:
        witness = Witness(len(self.witness_map))
        self.witness_map.append([])
        return witness

    def add_witnesses_to_map(self, a: Witness, b: Witness, c: Witness,
                             d: Witness, gate_index: int) -> None:
        wm = self.witness_map
        wm[a.index].append(WireData(WireData.LEFT, gate_index))
        wm[b.index].append(WireData(WireData.RIGHT, gate_index))
        wm[c.index].append(WireData(WireData.OUTPUT, gate_index))
        wm[d.index].append(WireData(WireData.FOURTH, gate_index))

    def compute_sigma_permutations(self, n: int) -> list[list[WireData]]:
        """Cycle-rotated sigma mappings (permutation.rs:76-109)."""
        sigmas = [[WireData(kind, i) for i in range(n)] for kind in range(4)]
        for wire_data_entries in self.witness_map:
            m = len(wire_data_entries)
            for wire_index, current in enumerate(wire_data_entries):
                nxt = wire_data_entries[(wire_index + 1) % m]
                sigmas[current.kind][current.gate] = nxt
        return sigmas

    @staticmethod
    def _lagrange_mapping(sigma_mapping: list[WireData],
                          roots: list[int]) -> list[Fr]:
        ks = (1, params.K1, params.K2, params.K3)
        return [Fr(ks[wd.kind] * roots[wd.gate] % _Q) for wd in sigma_mapping]

    def compute_sigma_polynomials(self, n: int, domain: Domain,
                                  device) -> list[Polynomial]:
        """Sigma values -> coefficient form via 4 iFFTs (permutation.rs:143-179)."""
        sigmas = self.compute_sigma_permutations(n)
        roots = domain._powers(domain.group_gen)
        return [Polynomial(domain.ifft(self._lagrange_mapping(s, roots),
                                       device))
                for s in sigmas]

    def compute_permutation_vec(self, domain: Domain,
                                wires: list[list[Fr]],
                                beta: Fr, gamma: Fr,
                                sigma_polys: list[Polynomial],
                                device) -> list[Fr]:
        """Grand-product accumulator z over the domain (permutation.rs:181-245).

        The per-gate numerator/denominator products and the running product
        run on device (the prefix scan is a log-depth associative_scan); the
        batch inversion of the denominators happens host-side (one modular
        inverse beats a 380-multiply Fermat ladder on device).
        """
        n = domain.size
        if n >= 1024:
            return self._permutation_vec_device(domain, wires, beta, gamma,
                                                sigma_polys, device)
        ks = (1, params.K1, params.K2, params.K3)
        b, g = beta.value, gamma.value
        sigma_evals = [[e.value for e in domain.fft(p.coeffs, device)]
                       for p in sigma_polys]
        roots = domain._powers(domain.group_gen)

        denominators = []
        numerators = []
        for i in range(n):
            num, den = 1, 1
            root = roots[i]
            for wire, k, sig in zip(wires, ks, sigma_evals):
                w = wire[i].value
                num = num * ((w + b * k % _Q * root + g) % _Q) % _Q
                den = den * ((w + b * sig[i] + g) % _Q) % _Q
            numerators.append(num)
            denominators.append(den)
        inv_dens = _batch_inverse(denominators, _Q)

        acc = []
        state = 1
        for num, inv in zip(numerators, inv_dens):
            acc.append(Fr(state))
            state = state * num % _Q * inv % _Q
        return acc

    @staticmethod
    def compute_permutation_tensor(domain: Domain, wire_tensors,
                                   sigma_eval_tensors, roots_tensor,
                                   beta: Fr, gamma: Fr, mesh=None,
                                   axis: str | None = None):
        """Fully device-resident grand product: [8, n] Montgomery wire
        evaluation tensors in, [8, n] z tensor out (permutation.rs:181-245),
        on the wires' device.

        The n denominator inversions collapse to ONE host inversion via
        inv(prefix_den_i) = inv(total) * suffix_den_{i+1}: both prefix and
        suffix products are log-depth scans on the device, or with `mesh`
        (whose home holds the wires) scans sharded over it
        (`collective.sharded_scan_mul`)."""
        ks = (1, params.K1, params.K2, params.K3)
        dev = roots_tensor.device
        g_col = dpoly.const_col(gamma.value, dev)
        b_col = dpoly.const_col(beta.value, dev)
        num = None
        den = None
        for wire, k, sig in zip(wire_tensors, ks, sigma_eval_tensors):
            bk = dpoly.const_col(beta.value * k % _Q, dev)
            num_t = lf.add(FR, lf.add(FR, wire,
                                      lf.mont_mul(FR, roots_tensor, bk)),
                           g_col)
            den_t = lf.add(FR, lf.add(FR, wire, lf.mont_mul(FR, sig, b_col)),
                           g_col)
            num = num_t if num is None else lf.mont_mul(FR, num, num_t)
            den = den_t if den is None else lf.mont_mul(FR, den, den_t)

        if mesh is None:
            pnum = dpoly.prefix_products(num)
            sden = dpoly.prefix_products(den, reverse=True)
        else:
            mesh.axis(axis)
            pnum = sharded_scan_mul(num, mesh)
            sden = sharded_scan_mul(den, mesh, reverse=True)
        total = FR.from_mont_array(sden[:, :1])[0]
        inv_total = dpoly.const_col(pow(total, -1, _Q), dev)
        tail = lf.mont_mul(FR, lf.mont_mul(FR, pnum[:, :-1], sden[:, 1:]),
                           inv_total)
        return torch.cat([dpoly.const_col(1, dev), tail], dim=-1)

    def _permutation_vec_device(self, domain: Domain, wires, beta: Fr,
                                gamma: Fr, sigma_polys, device) -> list[Fr]:
        n = domain.size
        ks = (1, params.K1, params.K2, params.K3)
        b_col = dpoly.const_col(beta.value, device)
        g_col = dpoly.const_col(gamma.value, device)
        roots = FR.to_mont_array(domain._powers(domain.group_gen), device)

        num = None
        den = None
        for wire, k, sig_poly in zip(wires, ks, sigma_polys):
            sig = domain.fft_device(dpoly.to_device(sig_poly.coeffs, n,
                                                    device))
            w = FR.to_mont_array([x.value for x in wire], device)
            bk = dpoly.const_col(beta.value * k % _Q, device)
            num_t = lf.add(FR, lf.add(FR, w, lf.mont_mul(FR, roots, bk)),
                           g_col)
            den_t = lf.add(FR, lf.add(FR, w, lf.mont_mul(FR, sig, b_col)),
                           g_col)
            num = num_t if num is None else lf.mont_mul(FR, num, num_t)
            den = den_t if den is None else lf.mont_mul(FR, den, den_t)

        inv_dens = _batch_inverse(FR.from_mont_array(den), _Q)
        ratio = lf.mont_mul(FR, num, FR.to_mont_array(inv_dens, device))
        # exclusive prefix product: z_0 = 1, z_i = prod_{j<i} ratio_j
        scan = dpoly.prefix_products(ratio)
        shifted = torch.cat([dpoly.const_col(1, device), scan[:, :-1]],
                            dim=-1)
        return [Fr(v) for v in FR.from_mont_array(shifted)]
