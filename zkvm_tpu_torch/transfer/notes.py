"""Phoenix's note arithmetic (dusk-network/phoenix), on the host and as
gadgets.

* value commitment: VC = [v] G + [b] G', v the note's 64-bit value and b
  its blinder;
* note hash: the Poseidon digest (Domain::Other) of (note type, VC.x,
  VC.y, note_pk.x, note_pk.y, position), the leaf of the note tree;
* nullifier: the digest (Domain::Other) of (note_pk'.x, note_pk'.y,
  position), note_pk' = [note_sk] G';
* ElGamal encryption of a point M under the public key pk with the
  blinder r: ([r] G, M + [r] pk) (`curves.jubjub.ElgamalCipher`).
"""

from __future__ import annotations

from ..curves.jubjub import ElgamalCipher, JubjubAffine, JubjubExtended
from ..fields import Fr, JubjubFr
from ..hashes.gadget import HashGadget
from ..hashes.poseidon import Domain, Hash
from ..plonk.composer import Composer
from ..plonk.constraint_system import Witness, WitnessPoint

GENERATOR = JubjubAffine.generator()
GENERATOR_NUMS = JubjubAffine.generator_nums()
VALUE_BIT_PAIRS = 32  # a note's value is a u64


def value_commitment(value: int, blinder: JubjubFr) -> JubjubAffine:
    return (JubjubExtended.generator() * value
            + JubjubExtended.generator_nums() * blinder).to_affine()


def note_hash(note_type: int, vc: JubjubAffine, note_pk: JubjubAffine,
              pos: int) -> Fr:
    return Hash.digest(Domain.Other, [Fr(note_type), vc.u, vc.v, note_pk.u,
                                      note_pk.v, Fr(pos)])[0]


def nullifier(note_pk_prime: JubjubAffine, pos: int) -> Fr:
    return Hash.digest(Domain.Other,
                       [note_pk_prime.u, note_pk_prime.v, Fr(pos)])[0]


def encrypt(pk: JubjubAffine, message: JubjubAffine,
            blinder: JubjubFr) -> tuple[JubjubAffine, JubjubAffine]:
    cipher = ElgamalCipher.encrypt(blinder, pk.to_extended(),
                                   JubjubExtended.generator(),
                                   message.to_extended())
    return cipher.gamma.to_affine(), cipher.delta.to_affine()


def value_commitment_gadget(composer: Composer, value: Witness,
                            blinder: Witness) -> WitnessPoint:
    """v range-checked to 64 bits, then [v] G + [b] G'."""
    composer.component_range(value, VALUE_BIT_PAIRS)
    p1 = composer.component_mul_generator(value, GENERATOR)
    p2 = composer.component_mul_generator(blinder, GENERATOR_NUMS)
    return composer.component_add_point(p1, p2)


def note_hash_gadget(composer: Composer, note_type: Witness,
                     vc: WitnessPoint, note_pk: WitnessPoint,
                     pos: Witness) -> Witness:
    return HashGadget.digest(composer, Domain.Other,
                             [note_type, vc.x, vc.y, note_pk.x, note_pk.y,
                              pos])[0]


def nullifier_gadget(composer: Composer, note_pk_prime: WitnessPoint,
                     pos: Witness) -> Witness:
    return HashGadget.digest(composer, Domain.Other,
                             [note_pk_prime.x, note_pk_prime.y, pos])[0]


def encrypt_gadget(composer: Composer, pk: WitnessPoint,
                   message: WitnessPoint,
                   blinder: Witness) -> tuple[WitnessPoint, WitnessPoint]:
    """([r] G, M + [r] pk): one fixed-base and one variable-base
    multiplication."""
    gamma = composer.component_mul_generator(blinder, GENERATOR)
    r_pk = composer.component_mul_point(blinder, pk)
    return gamma, composer.component_add_point(message, r_pk)
