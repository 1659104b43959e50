"""Compiler: circuit -> preprocessed Prover/Verifier (plonk/src/compiler.rs).

Counterpart of `zkvm_tpu/plonk/compiler.py`.  The device work runs on the
commit key's device: ONE batched iFFT of the 15 selector and sigma columns,
ONE multi-set MSM of the live ones, and ONE batched coset FFT of the 16
extended evaluation tables onto the 8n domain, each through a `Domain`
method.  The keys it returns (host `Polynomial` and `Evaluations`, byte for
byte the reference's) carry the device tensors it made as their device
caches, so the first proof on that device does not lift them again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import Fr
from ..ops.limb_field import FR
from ..ops.ntt import Domain, _batch_inverse
from . import dpoly
from . import widgets
from .composer import Composer
from .evaluations import Evaluations
from .kzg10 import Commitment, CommitKey, KZGError, OpeningKey, \
    PublicParameters
from .polynomial import Polynomial
from .prover import Prover
from .quotient import _SELECTOR_PAIRS
from .verifier import Verifier

_Q = Fr.MODULUS


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class Compiler:
    @staticmethod
    def compile(pp: PublicParameters, label: bytes,
                circuit_cls) -> tuple[Prover, Verifier]:
        """compile::<C> with C::default() (compiler.rs:23-34)."""
        return Compiler.compile_with_circuit(pp, label, circuit_cls())

    @staticmethod
    def compile_with_circuit(pp: PublicParameters, label: bytes,
                             circuit) -> tuple[Prover, Verifier]:
        composer = Composer.initialized()
        circuit.circuit(composer)
        return Compiler._compile_with_composer(pp, label, composer)

    @staticmethod
    def compile_with_compressed(pp: PublicParameters, label: bytes,
                                compressed: bytes) -> tuple[Prover, Verifier]:
        from .compress import CompressedCircuit

        composer = CompressedCircuit.from_bytes(compressed)
        return Compiler._compile_with_composer(pp, label, composer)

    @staticmethod
    def _compile_with_composer(pp: PublicParameters, label: bytes,
                               composer: Composer) -> tuple[Prover, Verifier]:
        n = _next_pow2(len(composer.constraints) + 6)
        commit, opening = pp.trim(n)
        return Compiler._preprocess(label, commit, opening, composer)

    @staticmethod
    def _preprocess(label: bytes, commit_key: CommitKey,
                    opening_key: OpeningKey,
                    composer: Composer) -> tuple[Prover, Verifier]:
        """compiler.rs:78-390, on the commit key's device."""
        dev = commit_key.device
        constraints = len(composer.constraints)
        size = _next_pow2(constraints)
        domain = Domain(size)

        names = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith",
                 "q_range", "q_logic", "q_fixed_group_add",
                 "q_variable_group_add")
        columns = {name: [Fr.zero()] * size for name in names}
        for i, gate in enumerate(composer.constraints):
            for name in names:
                columns[name][i] = getattr(gate, name)

        # ONE batched device iFFT for all 15 columns (11 selectors + 4
        # sigma mappings) -- compiler.rs:93-149 runs 15 serial iFFTs
        sigma_names = ("s_sigma_1", "s_sigma_2", "s_sigma_3", "s_sigma_4")
        sigmas = composer.perm.compute_sigma_permutations(size)
        roots = domain._powers(domain.group_gen)
        sigma_cols = [composer.perm._lagrange_mapping(s, roots)
                      for s in sigmas]
        all_names = list(names) + list(sigma_names)
        all_cols = [columns[nm] for nm in names] + sigma_cols
        flat = []
        for col in all_cols:
            flat.extend(v.value for v in col)
        stacked = FR.to_mont_array(flat, dev).reshape(
            FR.n_limbs, len(all_cols), size).transpose(0, 1).contiguous()
        coeffs = domain.ifft_device(stacked)  # [15, 8, size]
        host_coeffs = FR.from_mont_array(coeffs)
        polys = {}
        for i, nm in enumerate(all_names):
            polys[nm] = Polynomial(
                [Fr(v) for v in host_coeffs[i * size:(i + 1) * size]])

        # ONE multi-set MSM for all live commits (compiler.rs:152-171);
        # all-zero selectors (degree 0) fall back to the identity
        # commitment (commit().unwrap_or_default()), sigma errors propagate
        live = [nm for nm in all_names if polys[nm].degree() > 0]
        for nm in sigma_names:
            if polys[nm].degree() == 0:
                raise KZGError("sigma polynomial degree is zero")
        live_comms = commit_key.commit_many_mont(
            [coeffs[all_names.index(nm)] for nm in live])
        comms = {nm: Commitment.identity() for nm in all_names}
        comms.update(dict(zip(live, live_comms)))

        verifier_key = widgets.VerifierKey.from_polynomial_commitments(
            constraints,
            comms["q_m"], comms["q_l"], comms["q_r"], comms["q_o"],
            comms["q_f"], comms["q_c"], comms["q_arith"], comms["q_logic"],
            comms["q_range"], comms["q_fixed_group_add"],
            comms["q_variable_group_add"],
            comms["s_sigma_1"], comms["s_sigma_2"], comms["s_sigma_3"],
            comms["s_sigma_4"])

        # ONE batched coset FFT onto the 8n domain for all 16 extended
        # evaluation tables (compiler.rs:239-306 runs 16 serial ones); the
        # 16th is the linear polynomial X
        domain_8n = Domain(8 * size)
        size_8n = domain_8n.size
        big = torch.cat([F.pad(coeffs, (0, size_8n - size)),
                         dpoly.to_device([0, 1], size_8n, dev)[None]])
        ev = domain_8n.coset_fft_device(big)  # [16, 8, 8n]
        host_ev = FR.from_mont_array(ev)
        evals_8n = {}
        for i, nm in enumerate(all_names):
            evals_8n[nm] = Evaluations(
                [Fr(v) for v in host_ev[i * size_8n:(i + 1) * size_8n]],
                domain_8n)
        linear_eval_8n = Evaluations(
            [Fr(v) for v in host_ev[len(all_names) * size_8n:]], domain_8n)
        v_h_coset_8n = Evaluations(
            domain.compute_vanishing_poly_over_coset(domain_8n.size),
            domain_8n)

        def pair(name):
            return (polys[name], evals_8n[name])

        prover_key = widgets.ProverKey(
            n=size,
            arithmetic=widgets.ArithmeticProverKey(
                pair("q_m"), pair("q_l"), pair("q_r"), pair("q_o"),
                pair("q_f"), pair("q_c"), pair("q_arith")),
            logic=widgets.LogicProverKey(pair("q_c"), pair("q_logic")),
            range=widgets.RangeProverKey(pair("q_range")),
            fixed_base=widgets.FixedBaseProverKey(
                pair("q_l"), pair("q_r"), pair("q_c"),
                pair("q_fixed_group_add")),
            variable_base=widgets.VariableBaseProverKey(
                pair("q_variable_group_add")),
            permutation=widgets.PermutationProverKey(
                pair("s_sigma_1"), pair("s_sigma_2"), pair("s_sigma_3"),
                pair("s_sigma_4"), linear_eval_8n),
            v_h_coset_8n=v_h_coset_8n)
        # the device tensors of the quotient round, as `quotient.
        # _device_cache` would lift them from the host values above
        v_h_inv = FR.to_mont_array(
            _batch_inverse([e.value for e in v_h_coset_8n.evals], _Q), dev)
        sel8 = {name: ev[all_names.index(name)] for _, name in _SELECTOR_PAIRS}
        prover_key._device_cache = {
            torch.device(dev): (sel8, v_h_inv, ev[len(all_names)])}

        prover = Prover(label, prover_key, commit_key, verifier_key,
                        size, constraints)
        verifier = Verifier(label, verifier_key, opening_key,
                            composer.public_input_indexes(), size,
                            constraints)
        return prover, verifier
