"""The plain reference against the program, on the CPU at small sizes:
the generator's openings, Poseidon, the circuit's layout, the SRS
trapdoor, the verifier key, a proof's verdict and a commitment."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from benchmark.reference import circuit as rc
from benchmark.reference import commit as rcommit
from benchmark.reference import curve, merkle, plonk, poseidon, srs
from benchmark.reference.field import R
from benchmark.reference.formats import MultipleLeavesData as RefLeaves
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.hashes.poseidon import Domain, Hash
from zkvm_tpu_torch.merkle import Item
from zkvm_tpu_torch.merkle.poseidon_tree import (PoseidonTree,
                                                 poseidon_opening_from_slice)
from zkvm_tpu_torch.plonk.composer import Composer
from zkvm_tpu_torch.service.batch import MultiOpeningCircuit, OpeningCircuit
from zkvm_tpu_torch.service.formats import MultipleLeavesData

from .conftest import host_commits


def test_merkle4_is_the_programs_poseidon():
    rnd = random.Random(5)
    for _ in range(3):
        xs = [rnd.randrange(R) for _ in range(4)]
        assert poseidon.merkle4(xs) == Hash.digest(
            Domain.Merkle4, [Fr(x) for x in xs])[0].value


@pytest.mark.parametrize("height, leaves", [(1, 3), (2, 9), (3, 20)])
def test_generated_openings_verify(height, leaves):
    root, positions, values, blob = merkle.make_pool(1234 + height, height,
                                                     leaves)
    assert positions == list(range(positions[0], positions[0] + leaves))
    data = MultipleLeavesData.from_rkyv_bytes(blob)
    ref = RefLeaves.from_rkyv_bytes(blob)
    assert ref.root_hash == data.root_hash
    assert [(i.position, i.leaf_hash, i.proof_bytes) for i in ref.leaves_info] == [
        (i.position, i.leaf_hash, i.proof_bytes) for i in data.leaves_info]
    assert Fr.from_bytes(data.root_hash).value == root
    tree = PoseidonTree(height)
    for pos, v in zip(positions, values):
        tree.insert(pos, Item(Fr(v), None))
    assert tree.root().hash.value == root
    for info, pos, v in zip(data.leaves_info, positions, values):
        assert info.position == pos
        opening = poseidon_opening_from_slice(info.proof_bytes, height)
        assert opening.verify(Item(Fr(v), None))
        assert info.proof_bytes == tree.opening(pos).to_var_bytes()
        branch, path = merkle.SparseTree(height, dict(
            zip(positions, values))).opening(pos)
        assert merkle.verify_opening(root, v, branch, path)
        assert not merkle.verify_opening(root, (v + 1) % R, branch, path)


@pytest.mark.parametrize("height, openings", [(1, 1), (2, 1), (1, 2)])
def test_layout_is_the_programs_circuit(height, openings):
    circuit = (OpeningCircuit.default_for_height(height) if openings == 1
               else MultiOpeningCircuit.default_for(height, openings))
    comp = Composer.initialized()
    circuit.circuit(comp)
    lay = rc.opening_circuit(height, openings)
    assert len(lay.gates) == len(comp.constraints)
    assert lay.witnesses == len(comp.witnesses)
    assert lay.public == comp.public_input_indexes()
    names = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c")
    for g, q, w in zip(comp.constraints, lay.gates, lay.wires):
        assert tuple(getattr(g, n).value for n in names) == q
        assert (g.a.index, g.b.index, g.c.index, g.d.index) == w
        assert (g.q_arith.value, g.q_range.value, g.q_logic.value,
                g.q_fixed_group_add.value,
                g.q_variable_group_add.value) == (1, 0, 0, 0, 0)


def test_height_17_layout_has_the_services_gate_count():
    assert len(rc.opening_circuit(17, 1).gates) == 17158
    assert rc.domain_size(17158) == 1 << 15
    assert len(rc.opening_circuit(17, 2).gates) == 34312


def test_trapdoor_is_the_setups(compiled):
    pp, _, _ = compiled
    tau, g = srs.trapdoor(5)
    assert curve.to_bytes(g) == pp.opening_key.g.to_bytes()
    pts = pp.commit_key.powers_of_g
    assert curve.to_bytes(curve.mul(g, pow(tau, 3, R))) == pts[3].to_bytes()


def test_verifier_key_is_the_compilers(compiled):
    _, _, verifier = compiled
    tau, g = srs.trapdoor(5)
    vk = rc.verifier_key(rc.opening_circuit(1, 1), tau, g)
    pvk = verifier.verifier_key
    want = {"q_m": pvk.arithmetic.q_m, "q_l": pvk.arithmetic.q_l,
            "q_r": pvk.arithmetic.q_r, "q_o": pvk.arithmetic.q_o,
            "q_f": pvk.arithmetic.q_f, "q_c": pvk.arithmetic.q_c,
            "q_arith": pvk.arithmetic.q_arith, "q_range": pvk.range.q_range,
            "q_logic": pvk.logic.q_logic,
            "q_fixed_group_add": pvk.fixed_base.q_fixed_group_add,
            "q_variable_group_add":
                pvk.variable_base.q_variable_group_add,
            "s_sigma_1": pvk.permutation.s_sigma_1,
            "s_sigma_2": pvk.permutation.s_sigma_2,
            "s_sigma_3": pvk.permutation.s_sigma_3,
            "s_sigma_4": pvk.permutation.s_sigma_4}
    assert vk["n"] == pvk.n
    for name, comm in want.items():
        assert curve.to_bytes(vk[name]) == comm.to_bytes(), name


def test_reference_verifier_judges_the_programs_proof(compiled):
    from zkvm_tpu_torch.rng import StdRng

    _, prover, verifier = compiled
    root, positions, values, blob = merkle.make_pool(77, 1, 2)
    info = MultipleLeavesData.from_rkyv_bytes(blob).leaves_info[0]
    opening = poseidon_opening_from_slice(info.proof_bytes, 1)
    leaf = Item(Fr.from_bytes(info.leaf_hash), None)
    proof, pis = prover.prove(StdRng(9), OpeningCircuit(opening, leaf))
    verifier.verify(proof, pis)
    tau, g = srs.trapdoor(5)
    lay = rc.opening_circuit(1, 1)
    vk = rc.verifier_key(lay, tau, g)
    raw = proof.to_bytes()
    plonk.verify(raw, {lay.public[0]: root}, vk, b"opening-circuit", tau, g)
    bad = bytearray(raw)
    bad[-1] ^= 1  # an evaluation altered
    with pytest.raises(plonk.Rejected):
        plonk.verify(bytes(bad), {lay.public[0]: root}, vk,
                     b"opening-circuit", tau, g)
    with pytest.raises(plonk.Rejected):
        plonk.verify(raw, {lay.public[0]: (root + 1) % R}, vk,
                     b"opening-circuit", tau, g)
    with pytest.raises(plonk.Rejected):
        plonk.verify(raw, {lay.public[0]: root}, vk, b"another-label", tau, g)


def test_reference_commitment_is_the_programs(compiled):
    pp, _, _ = compiled
    key, _ = pp.trim(16)
    gen = torch.Generator().manual_seed(3)
    words = torch.randint(0, 1 << 32, (8, 18), generator=gen,
                          dtype=torch.int64)
    words[7] %= R >> 224
    t = words.to(torch.int32)
    tau, g = srs.trapdoor(5)
    got = host_commits(key, [t])[0].to_bytes()
    assert rcommit.commitment(t.numpy(), tau, g) == got
    assert rcommit.commitment(t.numpy(), tau, g, drop_top_limb=True) != got
    ints = rcommit.words_to_ints(np.asarray(t))
    assert all(0 <= v < R for v in ints)
