"""Phoenix's transfer circuit (phoenix-circuits `TxCircuit<H, I>`): I input
notes of a height-H Poseidon arity-4 note tree spent into 2 output notes.

Public inputs, in the order the circuit appends them: the payload hash,
the tree's root; each input's nullifier; each output's value commitment
(x, y) and the two ElGamal ciphertexts of the sender's keys (gamma.x,
gamma.y, delta.x, delta.y for A, then for B); max_fee and deposit.

Each input note: its value range-checked to 64 bits and committed, the
note hash opened to the root, the nullifier recomputed from note_pk' and
the position, and the double signature of the payload hash by the note's
key checked.  Each output note: its value range-checked and committed to
the public commitment, and the sender's public keys A and B encrypted
under its note key.  Then the values balance (inputs = outputs + max_fee
+ deposit) and the sender's single signatures by A and B over the payload
hash are checked.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.jubjub import JubjubAffine
from ..fields import Fr, JubjubFr
from ..merkle.poseidon_tree import ARITY, Item, opening_gadget
from ..merkle.tree import Opening
from ..plonk.composer import Circuit, Composer
from ..plonk.constraint_system import Constraint
from . import notes
from .schnorr import (Signature, SignatureDouble,
                      verify_signature_double_gadget, verify_signature_gadget)

OUTPUT_NOTES = 2


@dataclass
class InputNote:
    note_type: int
    value: int
    blinder: JubjubFr
    note_pk: JubjubAffine
    note_pk_prime: JubjubAffine
    pos: int
    opening: Opening
    nullifier: Fr
    signature: SignatureDouble


@dataclass
class OutputNote:
    value: int
    blinder: JubjubFr
    value_commitment: JubjubAffine
    note_pk: JubjubAffine
    sender_blinders: tuple[JubjubFr, JubjubFr]
    # the ElGamal ciphertexts (gamma, delta) of sender_pk.A and .B
    sender_enc: tuple[tuple[JubjubAffine, JubjubAffine],
                      tuple[JubjubAffine, JubjubAffine]]


def _empty_opening(height: int) -> Opening:
    zero = Item(Fr.zero(), None)
    return Opening(None, root=zero, branch=[[zero] * ARITY
                                            for _ in range(height)],
                   positions=[0] * height, height=height, arity=ARITY)


class TxCircuit(Circuit):
    def __init__(self, inputs: list[InputNote], outputs: list[OutputNote],
                 payload_hash: Fr, root: Fr, max_fee: int, deposit: int,
                 sender_pk: tuple[JubjubAffine, JubjubAffine],
                 signatures: tuple[Signature, Signature]):
        if len(outputs) != OUTPUT_NOTES:
            raise ValueError(f"a transfer has {OUTPUT_NOTES} output notes")
        self.inputs = inputs
        self.outputs = outputs
        self.payload_hash = payload_hash
        self.root = root
        self.max_fee = max_fee
        self.deposit = deposit
        self.sender_pk = sender_pk
        self.signatures = signatures

    @classmethod
    def default(cls, inputs: int, height: int) -> "TxCircuit":
        """The circuit's shape with every witness zero (points the
        identity): what a compile synthesizes."""
        zero, s0, o = Fr.zero(), JubjubFr.zero(), JubjubAffine.identity()
        note_in = InputNote(0, 0, s0, o, o, 0, _empty_opening(height), zero,
                            SignatureDouble(s0, o, o))
        note_out = OutputNote(0, s0, o, o, (s0, s0), ((o, o), (o, o)))
        return cls([note_in] * inputs, [note_out] * OUTPUT_NOTES, zero, zero,
                   0, 0, (o, o), (Signature(s0, o), Signature(s0, o)))

    def circuit(self, composer: Composer) -> None:
        c = composer
        payload_hash = c.append_public(self.payload_hash)
        root = c.append_public(self.root)

        inputs_sum = Composer.ZERO
        for note in self.inputs:
            note_pk = c.append_point(note.note_pk)
            note_pk_prime = c.append_point(note.note_pk_prime)
            note_type = c.append_witness(note.note_type)
            pos = c.append_witness(note.pos)
            value = c.append_witness(note.value)
            blinder = c.append_witness(note.blinder)
            u = c.append_witness(note.signature.u)
            r = c.append_point(note.signature.R)
            r_prime = c.append_point(note.signature.R_prime)

            vc = notes.value_commitment_gadget(c, value, blinder)
            leaf = notes.note_hash_gadget(c, note_type, vc, note_pk, pos)
            c.assert_equal(opening_gadget(c, note.opening, leaf), root)
            nullifier = notes.nullifier_gadget(c, note_pk_prime, pos)
            c.assert_equal_constant(nullifier, Fr.zero(), note.nullifier)
            verify_signature_double_gadget(c, u, r, r_prime, note_pk,
                                           note_pk_prime, payload_hash)
            inputs_sum = c.gate_add(Constraint().left(1).a(inputs_sum)
                                    .right(1).b(value))

        sender_a = c.append_point(self.sender_pk[0])
        sender_b = c.append_point(self.sender_pk[1])
        outputs_sum = Composer.ZERO
        for note in self.outputs:
            value = c.append_witness(note.value)
            blinder = c.append_witness(note.blinder)
            vc = notes.value_commitment_gadget(c, value, blinder)
            c.assert_equal_public_point(vc, note.value_commitment)
            outputs_sum = c.gate_add(Constraint().left(1).a(outputs_sum)
                                     .right(1).b(value))
            note_pk = c.append_point(note.note_pk)
            for key, r, (gamma, delta) in zip(
                    (sender_a, sender_b), note.sender_blinders,
                    note.sender_enc):
                blinder_w = c.append_witness(r)
                enc_gamma, enc_delta = notes.encrypt_gadget(c, note_pk, key,
                                                            blinder_w)
                c.assert_equal_public_point(enc_gamma, gamma)
                c.assert_equal_public_point(enc_delta, delta)

        max_fee = c.append_public(Fr(self.max_fee))
        deposit = c.append_public(Fr(self.deposit))
        spent = c.gate_add(Constraint().left(1).a(outputs_sum).right(1)
                           .b(max_fee).fourth(1).d(deposit))
        c.assert_equal(inputs_sum, spent)

        for key, sig in zip((sender_a, sender_b), self.signatures):
            u = c.append_witness(sig.u)
            r = c.append_point(sig.R)
            verify_signature_gadget(c, u, r, key, payload_hash)
