"""JubJub Schnorr signatures (jubjub-schnorr): single and double.

A signature by the secret key sk over a message m (a field element) with
the nonce r: R = [r] G, c = the truncated Poseidon hash (Domain::Other)
of (R.x, R.y, m), u = r - c sk in JubJub's scalar field.  It verifies
when [u] G + [c] pk = R, pk = [sk] G.  The double signature commits to
the same key under both generators: R' = [r] G', c hashes (R, R', m), and
[u] G' + [c] pk' = R' holds as well, pk' = [sk] G'.

The gadgets check the same equations in a circuit: the challenge through
`HashGadget.digest_truncated`, [u] G by the fixed-base multiplication,
[c] pk by the variable-base one.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.jubjub import JubjubAffine, JubjubExtended
from ..fields import Fr, JubjubFr
from ..hashes.gadget import HashGadget
from ..hashes.poseidon import Domain, Hash
from ..plonk.composer import Composer
from ..plonk.constraint_system import Witness, WitnessPoint
from .notes import GENERATOR, GENERATOR_NUMS


@dataclass(frozen=True)
class Signature:
    u: JubjubFr
    R: JubjubAffine


@dataclass(frozen=True)
class SignatureDouble:
    u: JubjubFr
    R: JubjubAffine
    R_prime: JubjubAffine


def _coords(*points: JubjubAffine) -> list[Fr]:
    return [c for p in points for c in (p.u, p.v)]


def challenge(msg: Fr, *points: JubjubAffine) -> JubjubFr:
    """c: the truncated digest of the nonce points' coordinates and m."""
    return Hash.digest_truncated(Domain.Other, _coords(*points) + [msg])[0]


def sign(sk: JubjubFr, msg: Fr, nonce: JubjubFr) -> Signature:
    R = (JubjubExtended.generator() * nonce).to_affine()
    c = challenge(msg, R)
    return Signature(nonce - c * sk, R)


def sign_double(sk: JubjubFr, msg: Fr, nonce: JubjubFr) -> SignatureDouble:
    R = (JubjubExtended.generator() * nonce).to_affine()
    R_prime = (JubjubExtended.generator_nums() * nonce).to_affine()
    c = challenge(msg, R, R_prime)
    return SignatureDouble(nonce - c * sk, R, R_prime)


def verify(sig: Signature, pk: JubjubAffine, msg: Fr) -> bool:
    c = challenge(msg, sig.R)
    return (JubjubExtended.generator() * sig.u + pk * c) == sig.R


def verify_double(sig: SignatureDouble, pk: JubjubAffine,
                  pk_prime: JubjubAffine, msg: Fr) -> bool:
    c = challenge(msg, sig.R, sig.R_prime)
    return ((JubjubExtended.generator() * sig.u + pk * c) == sig.R
            and (JubjubExtended.generator_nums() * sig.u + pk_prime * c)
            == sig.R_prime)


def verify_signature_gadget(composer: Composer, u: Witness, r: WitnessPoint,
                            pk: WitnessPoint, msg: Witness) -> None:
    """jubjub-schnorr's `verify_signature`: [u] G + [c] pk = R."""
    c = HashGadget.digest_truncated(composer, Domain.Other,
                                    [r.x, r.y, msg])[0]
    s_a = composer.component_mul_generator(u, GENERATOR)
    s_b = composer.component_mul_point(c, pk)
    composer.assert_equal_point(r, composer.component_add_point(s_a, s_b))


def verify_signature_double_gadget(composer: Composer, u: Witness,
                                   r: WitnessPoint, r_prime: WitnessPoint,
                                   pk: WitnessPoint, pk_prime: WitnessPoint,
                                   msg: Witness) -> None:
    """jubjub-schnorr's `verify_signature_double`: [u] G + [c] pk = R and
    [u] G' + [c] pk' = R'."""
    c = HashGadget.digest_truncated(
        composer, Domain.Other,
        [r.x, r.y, r_prime.x, r_prime.y, msg])[0]
    s_a = composer.component_mul_generator(u, GENERATOR)
    s_b = composer.component_mul_point(c, pk)
    point_a = composer.component_add_point(s_a, s_b)
    s_c = composer.component_mul_generator(u, GENERATOR_NUMS)
    s_d = composer.component_mul_point(c, pk_prime)
    point_b = composer.component_add_point(s_c, s_d)
    composer.assert_equal_point(r, point_a)
    composer.assert_equal_point(r_prime, point_b)
