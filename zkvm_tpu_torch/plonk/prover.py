"""Prover: the 5-round PLONK proving flow (plonk/src/compiler/prover.rs).

Round structure (prover.rs:210-509):
  1. wire polynomials a,b,c,d: blind + commit
  2. permutation grand product z: blind + commit
  3. quotient t: build over the 8n coset, split in 4, cross-blind, commit
  4. evaluations at z / z*omega
  5. linearization r, aggregate KZG witnesses W_z and W_zw

Every polynomial lives on the device as an [8, len] int32 Montgomery tensor
from witness ingestion to the final commitments -- wire iFFTs, the grand
product, the 8n quotient, the 15 round-4 evaluations, the linearization
combination and both ruffini divisions run on the commit key's device (see
plonk/dpoly.py).  Host work per round is only the merlin transcript
(inherently serial, bytes-sized) and the rng blinder draws.

Counterpart of `zkvm_tpu/plonk/prover.py`.  The reference's round programs
are `jit` programs; here they are plain functions of the same steps
(`_round_programs`), challenges and blinders entering as [8, k] Montgomery
columns.  Every transform is a `Domain` method (`fft_device`,
`ifft_device`, `coset_fft_device`, `coset_ifft_device`): the one seam
through which the prover reaches the NTT, the staged route (the
`ntt_stages` kernel on the card).  With a mesh
(`ops.collective.Mesh`, whose home is the commit key's device), rounds 1-3
take the sharded set (`_mesh_round_programs`): distributed 4-step NTTs,
cross-shard grand-product scans, the sharded quotient and sharded commit
MSMs; rounds 4 and 5 run on the home device.  The proof bytes are the
reference's, with a mesh or without.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import Fr
from ..ops import limb_field as lf
from ..ops.collective import Mesh, resolve_device
from ..ops.limb_field import FR
from ..ops.ntt import Domain
from ..ops.ntt_sharded import DistributedDomain
from ..utils import metrics
from . import dpoly
from .composer import Composer
from .errors import NotEnoughBytes
from .kzg10 import CommitKey
from .permutation import Permutation
from .polynomial import Polynomial
from .proof import Proof, compute_barycentric_eval
from .quotient import build_quotient_device
from .transcript import Transcript
from .widgets import (ProofEvaluations, ProverKey, VerifierKey,
                      _fixed_base_identity, _logic_identity, _range_identity,
                      _var_base_identity)

from .. import params as _params

_Q = Fr.MODULUS
K1, K2, K3 = _params.K1, _params.K2, _params.K3


def base_transcript(label: bytes, verifier_key: VerifierKey,
                    constraints: int) -> Transcript:
    """TranscriptProtocol::base (transcript.rs:51-65)."""
    t = Transcript(label)
    t.circuit_domain_sep(constraints)
    verifier_key.seed_transcript(t)
    return t


def blind_poly(rng, witnesses: list[Fr], hiding_degree: int,
               domain: Domain, device) -> Polynomial:
    """iFFT + hiding blinders (prover.rs:64-83) -- host-Polynomial helper
    kept for tests and non-hot callers; the iFFT runs on `device`."""
    coeffs = domain.ifft(witnesses, device)
    for i in range(hiding_degree + 1):
        blinder = Fr.random(rng)
        coeffs[i] = coeffs[i] - blinder
        coeffs.append(blinder)
    return Polynomial(coeffs)


def _pk_device(pk: ProverKey, domain: Domain, device):
    """Device-resident ProverKey tensors on `device`, built once per key and
    device:

    coeff: [8, n] coefficient tensors of the 15 selector/sigma polynomials
    sigma_evals: 4x [8, n] Lagrange-basis sigma values (grand product)
    roots: [8, n] domain element table
    """
    device = torch.device(device)
    caches = pk.__dict__.setdefault("_device_poly_cache", {})
    cache = caches.get(device)
    if cache is not None:
        return cache
    n = domain.size
    fams = (("q_m", pk.arithmetic.q_m), ("q_l", pk.arithmetic.q_l),
            ("q_r", pk.arithmetic.q_r), ("q_o", pk.arithmetic.q_o),
            ("q_f", pk.arithmetic.q_f), ("q_c", pk.arithmetic.q_c),
            ("q_arith", pk.arithmetic.q_arith),
            ("q_range", pk.range.q_range), ("q_logic", pk.logic.q_logic),
            ("q_fixed_group_add", pk.fixed_base.q_fixed_group_add),
            ("q_variable_group_add",
             pk.variable_base.q_variable_group_add),
            ("s_sigma_1", pk.permutation.s_sigma_1),
            ("s_sigma_2", pk.permutation.s_sigma_2),
            ("s_sigma_3", pk.permutation.s_sigma_3),
            ("s_sigma_4", pk.permutation.s_sigma_4))
    coeff = {name: dpoly.to_device(pair[0].coeffs, n, device)
             for name, pair in fams}
    sigmas = torch.stack([coeff[f"s_sigma_{i}"] for i in range(1, 5)])
    sigma_evals = list(domain.fft_device(sigmas).unbind(0))
    roots = dpoly.powers_device(dpoly.const_col(domain.group_gen, device), n)
    cache = caches[device] = {"coeff": coeff, "sigma_evals": sigma_evals,
                              "roots": roots}
    return cache


def _blind(coeffs, b_cols):
    """Hiding blinders of one wire or z polynomial (prover.rs:64-83)."""
    k = b_cols.shape[-1]
    low = lf.sub(FR, coeffs[:, :k], b_cols)
    return torch.cat([low, coeffs[:, k:], b_cols], dim=-1)


def _split_quotient(t_coeffs, n: int, blinders):
    """The quotient split into four chunks, cross-blinded by the [8, 3]
    columns (b12, b13, b14)."""
    bcols = [blinders[:, i:i + 1] for i in range(3)]

    def cross(chunk, head_b, tail_b):
        head = (chunk[:, :1] if head_b is None else
                lf.sub(FR, chunk[:, :1], head_b))
        parts = [head, chunk[:, 1:]]
        if tail_b is not None:
            parts.append(tail_b)
        return torch.cat(parts, dim=-1)

    return (cross(t_coeffs[:, :n], None, bcols[0]),
            cross(t_coeffs[:, n:2 * n], bcols[0], bcols[1]),
            cross(t_coeffs[:, 2 * n:3 * n], bcols[1], bcols[2]),
            cross(t_coeffs[:, 3 * n:4 * n + 7], bcols[2], None))


def _round_programs(pk: ProverKey, domain: Domain, device):
    """The device part of each prover round, as plain functions over [8, k]
    Montgomery tensors on `device`, built once per key, size and device.

    Round 1 blinds the four wire polynomials, round 2 computes and blinds
    the grand product, round 3 builds and splits the quotient, round 4
    evaluates the 15 polynomials, round 5 forms the linearisation and the
    two opening witnesses.  Blinders enter as [8, k] columns; the
    challenges of rounds 2-5 as host scalars that become [8, 1] columns at
    their first use.
    """
    device = torch.device(device)
    caches = pk.__dict__.setdefault("_round_programs_cache", {})
    cache = caches.get((domain.size, device))
    if cache is not None:
        return cache
    n = domain.size
    dc = _pk_device(pk, domain, device)
    co = dc["coeff"]

    def p1_wires(wires, blinders):  # wires [4, 8, n]; blinders [8, 8]
        coeffs4 = domain.ifft_device(wires)
        return tuple(_blind(coeffs4[k], blinders[:, 2 * k: 2 * k + 2])
                     for k in range(4))

    def p2_z(wires, beta, gamma, blinders):  # blinders [8, 3]
        z_ev = Permutation.compute_permutation_tensor(
            domain, wires.unbind(0), dc["sigma_evals"], dc["roots"], beta,
            gamma)
        return _blind(domain.ifft_device(z_ev), blinders)

    def p3_quotient(wp, z_poly, pi_dense, challenges, blinders):
        # blinders: [8, 3] (b12, b13, b14)
        pi_coeffs = domain.ifft_device(pi_dense)
        t_coeffs = build_quotient_device(domain, pk, z_poly, wp, pi_coeffs,
                                         challenges)
        return _split_quotient(t_coeffs, n, blinders)

    # round-4 evaluation stacks: the static selector/sigma part, once
    m_z = n + 2
    stat_z = torch.stack([F.pad(co[nm], (0, m_z - n))
                          for nm in ("s_sigma_1", "s_sigma_2", "s_sigma_3",
                                     "q_arith", "q_c", "q_l", "q_r")])
    m_w = n + 3

    def p4_evals(wp, z_poly, z_challenge, shifted):
        stack_z = torch.cat([torch.stack(wp), stat_z])
        at_w = torch.stack([F.pad(t, (0, m_w - t.shape[-1]))
                            for t in (wp[0], wp[1], wp[3], z_poly)])
        return (dpoly.eval_stack(stack_z, z_challenge),
                dpoly.eval_stack(at_w, shifted))

    lin_size = n + 7  # t_fourth carries the degree-(n+6) tail
    lin_names = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_range",
                 "q_logic", "q_fixed_group_add", "q_variable_group_add")

    def p5_openings(wp, z_poly, t4, sc):
        # sc: the 33 scalars of _prove_fast, in its layout
        terms = [(co[nm], sc[i]) for i, nm in enumerate(lin_names)]
        terms += [(z_poly, sc[10]), (co["s_sigma_4"], sc[11])]
        terms += [(t, sc[13 + j]) for j, t in enumerate(t4)]
        lin = dpoly.lin_comb(terms, lin_size, device)
        lin = torch.cat([lf.add(FR, lin[:, :1],
                                dpoly.const_col(sc[12].value, device)),
                         lin[:, 1:]], dim=-1)
        sig = [co["s_sigma_1"], co["s_sigma_2"], co["s_sigma_3"]]
        agg = dpoly.lin_comb(
            [(lin, Fr.one())]  # v^0 = 1
            + [(t, sc[18 + j]) for j, t in enumerate(list(wp) + sig)],
            lin_size, device)
        w_z = dpoly.ruffini_device(agg, sc[29])
        sagg = dpoly.lin_comb(
            [(z_poly, Fr.one())]
            + [(t, sc[26 + j]) for j, t in enumerate((wp[0], wp[1], wp[3]))],
            lin_size, device)
        w_zw = dpoly.ruffini_device(sagg, sc[31])
        return w_z, w_zw

    cache = caches[(domain.size, device)] = {
        "p1": p1_wires, "p2": p2_z, "p3": p3_quotient, "p4": p4_evals,
        "p5": p5_openings}
    return cache


def _mesh_round_programs(pk: ProverKey, domain: Domain, mesh: Mesh,
                         axis: str):
    """The round programs of a prove over `mesh`, built once per key, size
    and mesh.  Rounds 1-3 swap their transforms for distributed 4-step NTTs
    (`DistributedDomain`), the grand product's scans for cross-shard scans
    and the quotient for its sharded form, with the same steps as the
    reference's `m1_wires`, `m2_scan` / `m2_z` and `m3_quotient`; every
    tensor between them is global, on the mesh's home device.  Rounds 4
    and 5 are `_round_programs`' own, on the home device, so the proof
    bytes equal the single-device prove's by construction."""
    caches = pk.__dict__.setdefault("_mesh_programs_cache", {})
    key = (domain.size, mesh, axis)
    cache = caches.get(key)
    if cache is not None:
        return cache
    n = domain.size
    rp = _round_programs(pk, domain, mesh.home)  # p4 / p5
    dc = _pk_device(pk, domain, mesh.home)
    ddom = DistributedDomain(n, mesh, axis)

    def m1_wires(wires, blinders):
        coeffs4 = ddom.ifft_device(wires)
        return tuple(_blind(coeffs4[k], blinders[:, 2 * k: 2 * k + 2])
                     for k in range(4))

    def m2_z(wires, beta, gamma, blinders):
        z_ev = Permutation.compute_permutation_tensor(
            domain, wires.unbind(0), dc["sigma_evals"], dc["roots"], beta,
            gamma, mesh=mesh, axis=axis)
        return _blind(ddom.ifft_device(z_ev), blinders)

    def m3_quotient(wp, z_poly, pi_dense, challenges, blinders):
        pi_coeffs = ddom.ifft_device(pi_dense)
        t_coeffs = build_quotient_device(domain, pk, z_poly, wp, pi_coeffs,
                                         challenges, mesh=mesh, axis=axis)
        return _split_quotient(t_coeffs, n, blinders)

    cache = caches[key] = {**rp, "p1": m1_wires, "p2": m2_z,
                           "p3": m3_quotient}
    return cache


class Prover:
    """Holds the preprocessed keys + base transcript (prover.rs:19-60).
    It proves on the commit key's device, or over a mesh whose home is
    that device."""

    def __init__(self, label: bytes, prover_key: ProverKey,
                 commit_key: CommitKey, verifier_key: VerifierKey,
                 size: int, constraints: int):
        self.label = bytes(label)
        self.prover_key = prover_key
        self.commit_key = commit_key
        self.verifier_key = verifier_key
        self.size = size
        self.constraints = constraints
        self.transcript = base_transcript(self.label, verifier_key,
                                          constraints)

    @property
    def device(self) -> torch.device:
        return self.commit_key.device

    # -- serialization (prover.rs:85-207) ----------------------------------------
    def to_bytes(self) -> bytes:
        prover_key = self.prover_key.to_var_bytes()
        commit_key = self.commit_key.to_raw_var_bytes()
        verifier_key = self.verifier_key.to_bytes()
        out = (len(self.label).to_bytes(8, "big")
               + len(prover_key).to_bytes(8, "big")
               + len(commit_key).to_bytes(8, "big")
               + len(verifier_key).to_bytes(8, "big")
               + self.size.to_bytes(8, "big")
               + self.constraints.to_bytes(8, "big"))
        return out + self.label + prover_key + commit_key + verifier_key

    @classmethod
    def try_from_bytes(cls, buf: bytes, device) -> "Prover":
        """A prover from its bytes (the reference's layout), proving on
        `device`."""
        if len(buf) < 48:
            raise NotEnoughBytes()
        label_len = int.from_bytes(buf[0:8], "big")
        pk_len = int.from_bytes(buf[8:16], "big")
        ck_len = int.from_bytes(buf[16:24], "big")
        vk_len = int.from_bytes(buf[24:32], "big")
        size = int.from_bytes(buf[32:40], "big")
        constraints = int.from_bytes(buf[40:48], "big")
        pos = 48
        label = buf[pos: pos + label_len]
        pos += label_len
        prover_key = ProverKey.from_slice(buf[pos: pos + pk_len])
        pos += pk_len
        commit_key = CommitKey.from_slice_unchecked(buf[pos: pos + ck_len],
                                                    device)
        pos += ck_len
        verifier_key = VerifierKey.from_bytes(buf[pos: pos + vk_len])
        return cls(label, prover_key, commit_key, verifier_key, size,
                   constraints)

    # -- proving (prover.rs:210-509) ----------------------------------------------
    def prove(self, rng, circuit, mesh: Mesh | None = None,
              shard_axis: str | None = None) -> tuple[Proof, list[Fr]]:
        """One proof on the commit key's device.  With `mesh` (whose home
        must be that device), the heavy device work of rounds 1-3 and
        every commit MSM shard over the mesh (`_mesh_round_programs`); the
        proof bytes are the same either way."""
        if mesh is None and shard_axis is not None:
            raise ValueError("shard_axis names an axis of a mesh; no mesh "
                             "was given")
        return self._prove_fast(rng, circuit, mesh, shard_axis)

    def _prove_fast(self, rng, circuit, mesh: Mesh | None = None,
                    shard_axis: str | None = None) -> tuple[Proof, list[Fr]]:
        # witness re-synthesis (composer.rs:964) is host Python and part of
        # every proof's cost -- measured so the flagship accounting closes.
        # GC is paused for the duration: synthesis allocates ~1.4M small
        # objects against a large live heap (device buffers, keys), and
        # collection passes tripled its wall time at the 2^16 flagship.
        import gc

        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            with metrics.GLOBAL.span("prove/witness_synthesis"):
                composer = Composer.prove(self.constraints, circuit)
        except BaseException:
            if gc_was_enabled:
                gc.enable()
            raise
        with metrics.GLOBAL.span("prove/preamble"):
            # GC comes back on inside the span: the collection that
            # synthesis deferred runs at the next call and is booked here
            if gc_was_enabled:
                gc.enable()
            n = self.size
            dev = self.device
            domain = Domain(n)
            transcript = self.transcript.clone()
            pk = self.prover_key
            if mesh is None:
                axis = None
                rp = _round_programs(pk, domain, dev)
            else:
                axis = mesh.axis(shard_axis)
                if mesh.home != resolve_device(dev):
                    raise ValueError(f"the mesh's home is {mesh.home}, the "
                                     f"prover's device is {dev}")
                dev = mesh.home
                rp = _mesh_round_programs(pk, domain, mesh, axis)

            public_inputs = composer.public_input_values()
            public_input_indexes = composer.public_input_indexes()
            dense_public_inputs = Composer.dense_public_inputs(
                public_input_indexes, public_inputs, n)
            for pi in public_inputs:
                transcript.append_scalar(b"pi", pi)

        with metrics.GLOBAL.span("prove/wire_ingest"):
            # one byte-encode per WITNESS, then vectorized numpy gathers
            # per wire column
            import numpy as np

            wit = composer.witnesses
            wit_raw = np.frombuffer(
                b"".join(w.value.to_bytes(32, "little") for w in wit),
                dtype="<u4").reshape(len(wit), FR.n_limbs)
            gates = composer.constraints
            n_con = len(gates)
            raw = np.zeros((4, n, FR.n_limbs), np.uint32)
            for col, sel in enumerate(("a", "b", "c", "d")):
                idx = np.fromiter(
                    (getattr(g, sel).index for g in gates), np.int64, n_con)
                raw[col, :n_con] = wit_raw[idx]
            wires = lf.to_mont(FR, lf.u32_to_tensor(
                raw.transpose(0, 2, 1), dev))  # [4, 8, n]

        def cols(values):
            return dpoly.to_device([v.value if isinstance(v, Fr) else v
                                    for v in values], len(values), dev)

        # ROUND 1
        with metrics.GLOBAL.span("prove/round1_wires"):
            blinders1 = [Fr.random(rng) for _ in range(8)]
            # rng order matches blind_poly per wire: (b0, b1) a, b, c, d
            wire_polys = rp["p1"](wires, cols(blinders1))
            a_comm, b_comm, c_comm, d_comm = \
                self.commit_key.commit_many_mont(list(wire_polys),
                                                 mesh=mesh, axis=axis)
            transcript.append_commitment(b"a_comm", a_comm)
            transcript.append_commitment(b"b_comm", b_comm)
            transcript.append_commitment(b"c_comm", c_comm)
            transcript.append_commitment(b"d_comm", d_comm)
            beta = transcript.challenge_scalar(b"beta")
            transcript.append_scalar(b"beta", beta)
            gamma = transcript.challenge_scalar(b"gamma")

        # ROUND 2
        with metrics.GLOBAL.span("prove/round2_permutation"):
            blinders2 = [Fr.random(rng) for _ in range(3)]
            z_poly = rp["p2"](wires, beta, gamma, cols(blinders2))
            z_comm = self.commit_key.commit_many_mont(
                [z_poly], mesh=mesh, axis=axis)[0]
            transcript.append_commitment(b"z_comm", z_comm)
            alpha = transcript.challenge_scalar(b"alpha")
            range_sep = transcript.challenge_scalar(
                b"range separation challenge")
            logic_sep = transcript.challenge_scalar(
                b"logic separation challenge")
            fixed_sep = transcript.challenge_scalar(
                b"fixed base separation challenge")
            var_sep = transcript.challenge_scalar(
                b"variable base separation challenge")

        # ROUND 3
        with metrics.GLOBAL.span("prove/round3_quotient"):
            b_t = [Fr.random(rng) for _ in range(3)]
            t4 = rp["p3"](wire_polys, z_poly,
                          dpoly.to_device(dense_public_inputs, n, dev),
                          (alpha, beta, gamma, range_sep, logic_sep,
                           fixed_sep, var_sep), cols(b_t))
            (t_low_comm, t_mid_comm, t_high_comm,
             t_fourth_comm) = self.commit_key.commit_many_mont(
                list(t4), mesh=mesh, axis=axis)
            transcript.append_commitment(b"t_low_comm", t_low_comm)
            transcript.append_commitment(b"t_mid_comm", t_mid_comm)
            transcript.append_commitment(b"t_high_comm", t_high_comm)
            transcript.append_commitment(b"t_fourth_comm", t_fourth_comm)
            z_challenge = transcript.challenge_scalar(b"z_challenge")

        # ROUND 4
        with metrics.GLOBAL.span("prove/round4_evaluations"):
            shifted = z_challenge * Fr(domain.group_gen)
            vals_z, vals_w = rp["p4"](wire_polys, z_poly, z_challenge,
                                      shifted)
            (a_eval, b_eval, c_eval, d_eval, s_sigma_1_eval, s_sigma_2_eval,
             s_sigma_3_eval, q_arith_eval, q_c_eval, q_l_eval,
             q_r_eval) = vals_z
            a_w_eval, b_w_eval, d_w_eval, z_eval = vals_w
            transcript.append_scalar(b"a_eval", a_eval)
            transcript.append_scalar(b"b_eval", b_eval)
            transcript.append_scalar(b"c_eval", c_eval)
            transcript.append_scalar(b"d_eval", d_eval)
            transcript.append_scalar(b"s_sigma_1_eval", s_sigma_1_eval)
            transcript.append_scalar(b"s_sigma_2_eval", s_sigma_2_eval)
            transcript.append_scalar(b"s_sigma_3_eval", s_sigma_3_eval)
            transcript.append_scalar(b"z_eval", z_eval)
            transcript.append_scalar(b"a_w_eval", a_w_eval)
            transcript.append_scalar(b"b_w_eval", b_w_eval)
            transcript.append_scalar(b"d_w_eval", d_w_eval)
            transcript.append_scalar(b"q_arith_eval", q_arith_eval)
            transcript.append_scalar(b"q_c_eval", q_c_eval)
            transcript.append_scalar(b"q_l_eval", q_l_eval)
            transcript.append_scalar(b"q_r_eval", q_r_eval)
            evaluations = ProofEvaluations(
                a_eval=a_eval, b_eval=b_eval, c_eval=c_eval, d_eval=d_eval,
                a_w_eval=a_w_eval, b_w_eval=b_w_eval, d_w_eval=d_w_eval,
                q_arith_eval=q_arith_eval, q_c_eval=q_c_eval,
                q_l_eval=q_l_eval, q_r_eval=q_r_eval,
                s_sigma_1_eval=s_sigma_1_eval,
                s_sigma_2_eval=s_sigma_2_eval,
                s_sigma_3_eval=s_sigma_3_eval, z_eval=z_eval)

        # ROUND 5
        with metrics.GLOBAL.span("prove/round5_openings"):
            v_challenge = transcript.challenge_scalar(b"v_challenge")
            v_w_challenge = transcript.challenge_scalar(b"v_w_challenge")
            qa = q_arith_eval
            beta_z = beta * z_challenge
            acc = ((a_eval + beta_z + gamma)
                   * (b_eval + Fr(K1) * beta_z + gamma)
                   * (c_eval + Fr(K2) * beta_z + gamma)
                   * (d_eval + Fr(K3) * beta_z + gamma) * alpha)
            zn = pow(z_challenge.value, n, _Q)
            l_1_z = (Fr((zn - 1) % _Q)
                     * Fr(pow(n * (z_challenge.value - 1) % _Q, -1, _Q))
                     if z_challenge.value != 1 else Fr.one())
            copy_acc = ((a_eval + beta * s_sigma_1_eval + gamma)
                        * (b_eval + beta * s_sigma_2_eval + gamma)
                        * (c_eval + beta * s_sigma_3_eval + gamma)
                        * (beta * z_eval) * alpha)
            pi_eval = compute_barycentric_eval(public_inputs, z_challenge,
                                               domain)
            z_h = Fr((zn - 1) % _Q)
            neg_zh = -z_h
            z_n = Fr(zn)
            vs = [Fr.one()]
            for _ in range(7):
                vs.append(vs[-1] * v_challenge)
            vws = [Fr.one()]
            for _ in range(3):
                vws.append(vws[-1] * v_w_challenge)
            scalars = [
                a_eval * b_eval * qa, a_eval * qa, b_eval * qa,
                c_eval * qa, d_eval * qa, qa,
                Fr(_range_identity(
                    range_sep.value, a_eval.value, b_eval.value,
                    c_eval.value, d_eval.value, d_w_eval.value)),
                Fr(_logic_identity(
                    logic_sep.value, a_eval.value, a_w_eval.value,
                    b_eval.value, b_w_eval.value, c_eval.value,
                    d_eval.value, d_w_eval.value, q_c_eval.value)),
                Fr(_fixed_base_identity(
                    fixed_sep.value, a_eval.value, a_w_eval.value,
                    b_eval.value, b_w_eval.value, c_eval.value,
                    d_eval.value, d_w_eval.value, q_l_eval.value,
                    q_r_eval.value, q_c_eval.value)),
                Fr(_var_base_identity(
                    var_sep.value, a_eval.value, a_w_eval.value,
                    b_eval.value, b_w_eval.value, c_eval.value,
                    d_eval.value, d_w_eval.value)),
                acc + l_1_z * alpha * alpha,
                -copy_acc,
                pi_eval,
                neg_zh, neg_zh * z_n, neg_zh * z_n * z_n,
                neg_zh * z_n * z_n * z_n,
            ] + vs + vws + [
                z_challenge, Fr(pow(z_challenge.value, -1, _Q)),
                shifted, Fr(pow(shifted.value, -1, _Q)),
            ]
            w_z, w_zw = rp["p5"](wire_polys, z_poly, t4, scalars)
            w_z_chall_comm, w_z_chall_w_comm = \
                self.commit_key.commit_many_mont([w_z, w_zw], mesh=mesh,
                                                 axis=axis)

        with metrics.GLOBAL.span("prove/release"):
            # the witness and its gates (~1.4M objects at height 17) are
            # freed here, by their last references, not unseen on return
            del composer, wit, gates
        proof = Proof(a_comm, b_comm, c_comm, d_comm, z_comm, t_low_comm,
                      t_mid_comm, t_high_comm, t_fourth_comm, w_z_chall_comm,
                      w_z_chall_w_comm, evaluations)
        return proof, public_inputs
