"""Dusk's Phoenix transfer in plain integers: the notes' arithmetic, the
seeded pool of transfers, the public inputs of each proof and the
transfer circuit's layout.

The arithmetic (dusk-network/phoenix, jubjub-schnorr):

* a Poseidon digest in Domain::Other: the SAFE sponge with the tag of
  (absorb n, squeeze 1) and domain separator 0, every input added to the
  rate with a permutation before each fifth, one permutation to squeeze;
  the truncated digest keeps its low 250 bits (a JubJub scalar);
* value commitment VC = [v] G + [b] G', note hash H(type, VC, note_pk,
  pos), nullifier H(note_pk', pos), note_pk = [sk] G, note_pk' = [sk] G';
* Schnorr: R = [r] G, c = truncated H(R, m), u = r - c sk mod the JubJub
  order, verified as [u] G + [c] pk = R; the double signature adds R' =
  [r] G', hashes (R, R', m) and checks [u] G' + [c] pk' = R' too;
* ElGamal: a point M under pk with blinder r is ([r] G, M + [r] pk).

`transfer_layout` lays the transfer circuit out gate by gate as the
program's composer does (phoenix-circuits' `TxCircuit`), from
`circuit.Layout`'s gadgets; a multi-segment hash is the flat hash of its
segments, since the sponge's consecutive absorbs merge into one.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from . import jubjub
from .circuit import ZERO, Layout
from .field import R, hash_to_scalar
from .merkle import ARITY, SparseTree
from .poseidon import WIDTH, io_tag_bytes, permute

OTHER_DOMAIN = 0
TRUNCATION = (1 << 250) - 1
VALUE_BIT_PAIRS = 32
OUTPUT_NOTES = 2
G, G_NUMS = jubjub.GENERATOR, jubjub.GENERATOR_NUMS


# -- JubJub in extended coordinates (a = -1): [k] P without inversions ------
def _ext_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % R
    b = (y1 + x1) * (y2 + x2) % R
    c = 2 * jubjub.D * t1 % R * t2 % R
    d = 2 * z1 * z2 % R
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % R, g * h % R, f * g % R, e * h % R


def mul(p, k: int):
    """[k] p, p affine, k >= 0; the affine result."""
    acc = (0, 1, 1, 0)
    base = (p[0], p[1], 1, p[0] * p[1] % R)
    for bit in bin(k)[2:] if k else "":
        acc = _ext_add(acc, acc)
        if bit == "1":
            acc = _ext_add(acc, base)
    zi = pow(acc[2], -1, R)
    return acc[0] * zi % R, acc[1] * zi % R


def lincomb(*terms):
    """sum of [k] p over (p, k) terms, affine."""
    out = jubjub.IDENTITY
    for p, k in terms:
        out = jubjub.add(out, mul(p, k))
    return out


# -- Poseidon, Domain::Other -------------------------------------------------
def digest(inputs: list[int]) -> int:
    state = [hash_to_scalar(io_tag_bytes(len(inputs), 1, OTHER_DOMAIN))]
    state += [0] * (WIDTH - 1)
    pos = 0
    for x in inputs:
        if pos == WIDTH - 1:
            state, pos = permute(state), 0
        state[pos + 1] = (state[pos + 1] + x) % R
        pos += 1
    return permute(state)[1]


def digest_truncated(inputs: list[int]) -> int:
    return digest(inputs) & TRUNCATION


# -- Phoenix's notes ----------------------------------------------------------
def value_commitment(value: int, blinder: int):
    return lincomb((G, value), (G_NUMS, blinder))


def note_hash(note_type: int, vc, note_pk, pos: int) -> int:
    return digest([note_type, vc[0], vc[1], note_pk[0], note_pk[1], pos])


def nullifier(note_pk_prime, pos: int) -> int:
    return digest([note_pk_prime[0], note_pk_prime[1], pos])


def encrypt(pk, message, blinder: int):
    return mul(G, blinder), jubjub.add(message, mul(pk, blinder))


# -- jubjub-schnorr -----------------------------------------------------------
def sign(sk: int, msg: int, nonce: int):
    """(u, R)."""
    big_r = mul(G, nonce)
    c = digest_truncated([*big_r, msg])
    return (nonce - c * sk) % jubjub.ORDER, big_r


def sign_double(sk: int, msg: int, nonce: int):
    """(u, R, R')."""
    big_r, big_r_prime = mul(G, nonce), mul(G_NUMS, nonce)
    c = digest_truncated([*big_r, *big_r_prime, msg])
    return (nonce - c * sk) % jubjub.ORDER, big_r, big_r_prime


def verify(sig, pk, msg: int) -> bool:
    u, big_r = sig
    c = digest_truncated([*big_r, msg])
    return lincomb((G, u), (pk, c)) == big_r


def verify_double(sig, pk, pk_prime, msg: int) -> bool:
    u, big_r, big_r_prime = sig
    c = digest_truncated([*big_r, *big_r_prime, msg])
    return (lincomb((G, u), (pk, c)) == big_r
            and lincomb((G_NUMS, u), (pk_prime, c)) == big_r_prime)


# -- the pool of transfers ----------------------------------------------------
@dataclass
class InputNote:
    note_type: int
    value: int
    blinder: int
    note_sk: int
    note_pk: tuple
    note_pk_prime: tuple
    pos: int
    hash: int
    branch: list
    positions: list
    nullifier: int
    signature: tuple  # (u, R, R')


@dataclass
class OutputNote:
    value: int
    blinder: int
    value_commitment: tuple
    note_pk: tuple
    sender_blinders: tuple
    sender_enc: tuple  # ((gamma, delta) of A, (gamma, delta) of B)


@dataclass
class Transfer:
    inputs: list
    outputs: list
    payload_hash: int
    root: int
    max_fee: int
    deposit: int
    sender_sk: tuple
    sender_pk: tuple
    signatures: tuple  # ((u, R) by A, (u, R) by B)


def _scalar(rnd) -> int:
    return rnd.randrange(1, jubjub.ORDER)


def _input_note(rnd, pos: int, value: int) -> InputNote:
    sk, blinder = _scalar(rnd), _scalar(rnd)
    pk, pk_prime = mul(G, sk), mul(G_NUMS, sk)
    note_type = rnd.randrange(2)
    vc = value_commitment(value, blinder)
    return InputNote(note_type, value, blinder, sk, pk, pk_prime, pos,
                     note_hash(note_type, vc, pk, pos), [], [],
                     nullifier(pk_prime, pos), ())


def _output_note(rnd, value: int, sender_pk) -> OutputNote:
    blinder = _scalar(rnd)
    note_pk = mul(G, _scalar(rnd))
    blinders = (_scalar(rnd), _scalar(rnd))
    enc = tuple(encrypt(note_pk, key, r) for key, r in zip(sender_pk,
                                                            blinders))
    return OutputNote(value, blinder, value_commitment(value, blinder),
                      note_pk, blinders, enc)


def make_pool(seed: int, inputs: int, height: int,
              count: int) -> list[Transfer]:
    """`count` transfers of `inputs` input notes each, every note distinct
    and at a seeded position of one sparse height-`height` tree (its root
    the one every transfer opens to), 2 output notes, fresh keys, seeded
    u64 values that balance (inputs = outputs + max_fee, deposit 0) and a
    seeded payload hash signed by every input's key and the sender's."""
    rnd = random.Random(f"phoenix-transfers-{seed}")
    positions = rnd.sample(range(ARITY ** height), inputs * count)
    transfers = []
    for k in range(count):
        notes = [_input_note(rnd, pos, rnd.randrange(1 << 62))
                 for pos in positions[inputs * k: inputs * (k + 1)]]
        total = sum(n.value for n in notes)
        max_fee = rnd.randrange(min(total, 1 << 40) + 1)
        first = rnd.randrange(total - max_fee + 1)
        sender_sk = (_scalar(rnd), _scalar(rnd))
        sender_pk = tuple(mul(G, sk) for sk in sender_sk)
        outputs = [_output_note(rnd, v, sender_pk)
                   for v in (first, total - max_fee - first)]
        payload_hash = rnd.randrange(R)
        for n in notes:
            n.signature = sign_double(n.note_sk, payload_hash, _scalar(rnd))
        sigs = tuple(sign(sk, payload_hash, _scalar(rnd)) for sk in sender_sk)
        transfers.append(Transfer(notes, outputs, payload_hash, 0, max_fee,
                                  0, sender_sk, sender_pk, sigs))
    tree = SparseTree(height, {n.pos: n.hash for t in transfers
                               for n in t.inputs})
    root = tree.root()
    for t in transfers:
        t.root = root
        for n in t.inputs:
            n.branch, n.positions = tree.opening(n.pos)
    return transfers


def public_inputs(t: Transfer) -> list[int]:
    """The proof's public inputs in the circuit's order: payload hash,
    root, the nullifiers, each output's value commitment and ciphertexts
    of A and B (gamma, delta), max_fee, deposit."""
    out = [t.payload_hash, t.root] + [n.nullifier for n in t.inputs]
    for o in t.outputs:
        points = [o.value_commitment]
        for gamma, delta in o.sender_enc:
            points += [gamma, delta]
        out += [c for p in points for c in p]
    return out + [t.max_fee, t.deposit]


# -- the layout -----------------------------------------------------------------
class TransferLayout(Layout):
    """`circuit.Layout` with the transfer's gadgets."""

    def public_witness(self) -> int:
        w = self.witness()
        self.assert_public(w)
        return w

    def assert_public_point(self, p) -> None:
        self.assert_public(p[0])
        self.assert_public(p[1])

    def assert_equal_point(self, p, q) -> None:
        self.assert_equal(p[0], q[0])
        self.assert_equal(p[1], q[1])

    def hash_segments(self, segments: list[list[int]],
                      domain: int = OTHER_DOMAIN) -> int:
        return self.hash([w for seg in segments for w in seg], domain)

    def value_commitment(self, value: int, blinder: int):
        self.range(value, VALUE_BIT_PAIRS)
        p1 = self.mul_generator(value, G)
        p2 = self.mul_generator(blinder, G_NUMS)
        return self.add_point(p1, p2)

    def encrypt(self, pk, message, blinder: int):
        gamma = self.mul_generator(blinder, G)
        return gamma, self.add_point(message, self.mul_point(blinder, pk))

    def schnorr(self, u: int, big_r, pk, msg: int) -> None:
        c = self.hash_truncated([*big_r, msg])
        s_a = self.mul_generator(u, G)
        s_b = self.mul_point(c, pk)
        self.assert_equal_point(big_r, self.add_point(s_a, s_b))

    def schnorr_double(self, u: int, big_r, big_r_prime, pk, pk_prime,
                       msg: int) -> None:
        c = self.hash_truncated([*big_r, *big_r_prime, msg])
        s_a = self.mul_generator(u, G)
        s_b = self.mul_point(c, pk)
        point_a = self.add_point(s_a, s_b)
        s_c = self.mul_generator(u, G_NUMS)
        s_d = self.mul_point(c, pk_prime)
        point_b = self.add_point(s_c, s_d)
        self.assert_equal_point(big_r, point_a)
        self.assert_equal_point(big_r_prime, point_b)


def transfer_layout(inputs: int, height: int) -> TransferLayout:
    """phoenix-circuits' TxCircuit<height, inputs> as the program's
    composer lays it out."""
    lay = TransferLayout()
    payload_hash = lay.public_witness()
    root = lay.public_witness()
    inputs_sum = ZERO
    for _ in range(inputs):
        note_pk, note_pk_prime = lay.point(), lay.point()
        note_type, pos, value, blinder, u = (lay.witness() for _ in range(5))
        big_r, big_r_prime = lay.point(), lay.point()
        vc = lay.value_commitment(value, blinder)
        leaf = lay.hash_segments([[note_type], list(vc), list(note_pk),
                                  [pos]])
        lay.assert_equal(lay.opening(height, leaf), root)
        lay.assert_public(lay.hash_segments([list(note_pk_prime), [pos]]))
        lay.schnorr_double(u, big_r, big_r_prime, note_pk, note_pk_prime,
                           payload_hash)
        inputs_sum = lay.gate_add((0, 1, 1, 0, 0), inputs_sum, value)
    sender = lay.point(), lay.point()
    outputs_sum = ZERO
    for _ in range(OUTPUT_NOTES):
        value, blinder = lay.witness(), lay.witness()
        lay.assert_public_point(lay.value_commitment(value, blinder))
        outputs_sum = lay.gate_add((0, 1, 1, 0, 0), outputs_sum, value)
        note_pk = lay.point()
        for key in sender:
            gamma, delta = lay.encrypt(note_pk, key, lay.witness())
            lay.assert_public_point(gamma)
            lay.assert_public_point(delta)
    max_fee, deposit = lay.public_witness(), lay.public_witness()
    spent = lay.gate_add((0, 1, 1, 1, 0), outputs_sum, max_fee, deposit)
    lay.assert_equal(inputs_sum, spent)
    for key in sender:
        u, big_r = lay.witness(), lay.point()
        lay.schnorr(u, big_r, key, payload_hash)
    return lay
