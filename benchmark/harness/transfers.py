"""The closed loop of a transfer prover: Dusk's Phoenix transfer proven
one at a time, as rusk-prover proves a wallet's transaction.

A `proofs.Loop` whose five hooks are the transfer's: set-up compiles
`TxCircuit(inputs, height)` (`zkvm_tpu_torch.transfer`) with every witness
zero; the pool is the reference's seeded transfers (`reference/phoenix.py`:
distinct input notes of one sparse note tree, balanced u64 values, fresh
keys, signatures over a seeded payload hash); a proof's circuit is a
transfer's witness read into the program's types, each note's opening
parsed from its wire bytes; its public inputs and layout are the
reference's.
"""

from __future__ import annotations

from zkvm_tpu_torch.curves.jubjub import JubjubAffine
from zkvm_tpu_torch.fields import Fr, JubjubFr
from zkvm_tpu_torch.merkle.poseidon_tree import poseidon_opening_from_slice
from zkvm_tpu_torch.transfer import (InputNote, OutputNote, Signature,
                                     SignatureDouble, TxCircuit)

from ..reference import merkle as ref_merkle
from ..reference import phoenix as ref_phoenix
from . import proofs


def _point(p) -> JubjubAffine:
    return JubjubAffine(Fr(p[0]), Fr(p[1]))


def tx_circuit(t, height: int) -> TxCircuit:
    """The program's circuit of the reference's transfer `t`."""
    inputs = []
    for n in t.inputs:
        opening = poseidon_opening_from_slice(
            ref_merkle.opening_bytes(t.root, n.branch, n.positions), height)
        u, big_r, big_r_prime = n.signature
        inputs.append(InputNote(
            n.note_type, n.value, JubjubFr(n.blinder), _point(n.note_pk),
            _point(n.note_pk_prime), n.pos, opening, Fr(n.nullifier),
            SignatureDouble(JubjubFr(u), _point(big_r),
                            _point(big_r_prime))))
    outputs = [OutputNote(
        o.value, JubjubFr(o.blinder), _point(o.value_commitment),
        _point(o.note_pk), tuple(JubjubFr(r) for r in o.sender_blinders),
        tuple((_point(g), _point(d)) for g, d in o.sender_enc))
        for o in t.outputs]
    sigs = tuple(Signature(JubjubFr(u), _point(big_r))
                 for u, big_r in t.signatures)
    return TxCircuit(inputs, outputs, Fr(t.payload_hash), Fr(t.root),
                     t.max_fee, t.deposit,
                     tuple(_point(p) for p in t.sender_pk), sigs)


class Loop(proofs.Loop):
    def shape(self) -> tuple[int, int]:
        return self.config["inputs"], self.config["tree"]["height"]

    def default_circuit(self):
        return TxCircuit.default(*self.shape())

    def make_inputs(self) -> int:
        inputs, height = self.shape()
        self.transfers = ref_phoenix.make_pool(
            self.seed, inputs, height,
            self.traffic["proofs"] + self.traffic["warmup"])
        return len(self.transfers)

    def circuit(self, i: int):
        return tx_circuit(self.transfers[i], self.shape()[1])

    def layout(self):
        return ref_phoenix.transfer_layout(*self.shape())

    def public_inputs(self, i: int, layout) -> list[int]:
        return ref_phoenix.public_inputs(self.transfers[i])
