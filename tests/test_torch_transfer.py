"""Phoenix's transfer in the port (`zkvm_tpu_torch.transfer`) against the
benchmark's plain reference (`benchmark/reference/phoenix.py`).

* The host arithmetic (Schnorr single and double, ElGamal, value
  commitment, note hash, nullifier) equals the reference's on seeded
  values.
* At the published shape (4 inputs, 2 outputs, a height-17 note tree) the
  composer's constraint system, synthesized on the host with no compile,
  is the reference's layout: the gate count, every selector column, the
  copy-constraint cycles and the public inputs; its witness satisfies
  every gate, and a wrong witness (a signature's u off by one, a nullifier
  of another position, values that do not balance) does not.
* Gadget circuits are proven by the port on the CPU and accepted by the
  reference verifier, an altered proof rejected: a range-checked value
  commitment and a 250-bit truncation (every gate family, a 2^10 prove)
  here; the single signature, the ElGamal encryption, the note hash +
  nullifier + opening (2^12) and the double signature (2^13), 25-100 s
  each on one thread, are `slow`.
"""

from __future__ import annotations

import random

import pytest
import torch

from benchmark.harness.transfers import tx_circuit
from benchmark.reference import circuit as rc
from benchmark.reference import jubjub as ref_jubjub
from benchmark.reference import merkle as ref_merkle
from benchmark.reference import phoenix as ref
from benchmark.reference import plonk as ref_plonk
from benchmark.reference import srs as ref_srs
from benchmark.reference.field import R
from zkvm_tpu_torch.curves.g1 import G1Affine
from zkvm_tpu_torch.curves.g2 import G2Affine
from zkvm_tpu_torch.curves.jubjub import JubjubAffine
from zkvm_tpu_torch.fields import Fp, Fr, JubjubFr
from zkvm_tpu_torch.merkle.poseidon_tree import (opening_gadget,
                                                 poseidon_opening_from_slice)
from zkvm_tpu_torch.native import native_msm
from zkvm_tpu_torch.plonk import (Circuit, CommitKey, Compiler, Composer,
                                  OpeningKey, PublicParameters)
from zkvm_tpu_torch.plonk.kzg10 import Commitment, powers_of
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.transfer import notes, schnorr
from zkvm_tpu_torch.utils import metrics

torch.set_num_threads(1)

SEED = 2_500_000_033
ORDER = ref_jubjub.ORDER


def point(p) -> JubjubAffine:
    return JubjubAffine(Fr(p[0]), Fr(p[1]))


def ints(p: JubjubAffine) -> tuple[int, int]:
    return p.u.value, p.v.value


# -- the host arithmetic --------------------------------------------------------
def test_host_arithmetic_equals_the_reference():
    rnd = random.Random(SEED)
    sk, nonce, blinder, r = (rnd.randrange(1, ORDER) for _ in range(4))
    msg, value, pos = rnd.randrange(R), rnd.randrange(1 << 64), rnd.randrange(4 ** 17)
    pk = point(ref.mul(ref.G, sk))
    pk_prime = point(ref.mul(ref.G_NUMS, sk))

    sig = schnorr.sign(JubjubFr(sk), Fr(msg), JubjubFr(nonce))
    assert (sig.u.value, ints(sig.R)) == ref.sign(sk, msg, nonce)
    assert schnorr.verify(sig, pk, Fr(msg))
    assert ref.verify((sig.u.value, ints(sig.R)), ints(pk), msg)
    off = schnorr.Signature(sig.u + JubjubFr(1), sig.R)
    assert not schnorr.verify(off, pk, Fr(msg))
    assert not ref.verify((off.u.value, ints(sig.R)), ints(pk), msg)

    dbl = schnorr.sign_double(JubjubFr(sk), Fr(msg), JubjubFr(nonce))
    assert ((dbl.u.value, ints(dbl.R), ints(dbl.R_prime))
            == ref.sign_double(sk, msg, nonce))
    assert schnorr.verify_double(dbl, pk, pk_prime, Fr(msg))
    assert not schnorr.verify_double(dbl, pk_prime, pk, Fr(msg))
    assert not ref.verify_double((dbl.u.value, ints(dbl.R), ints(dbl.R_prime)),
                                 ints(pk), ints(pk), msg)

    vc = notes.value_commitment(value, JubjubFr(blinder))
    assert ints(vc) == ref.value_commitment(value, blinder)
    assert (notes.note_hash(1, vc, pk, pos).value
            == ref.note_hash(1, ints(vc), ints(pk), pos))
    assert (notes.nullifier(pk_prime, pos).value
            == ref.nullifier(ints(pk_prime), pos))
    gamma, delta = notes.encrypt(pk, pk_prime, JubjubFr(r))
    assert (ints(gamma), ints(delta)) == ref.encrypt(ints(pk), ints(pk_prime), r)


# -- the constraint system at the published shape ---------------------------------


def unsatisfied(comp: Composer, sep: int = 7) -> list[int]:
    """The gates whose identity the composer's witness does not meet: the
    arithmetic identity with the gate's public input, and each custom gate
    family's term (the reference verifier's, over this row and the next)."""
    w = [x.value for x in comp.witnesses]
    rows = [(g, [w[x.index] for x in (g.a, g.b, g.c, g.d)])
            for g in comp.constraints]
    zero_row = (None, [0, 0, 0, 0])
    bad = []
    for i, (g, (a, b, c, d)) in enumerate(rows):
        pi = comp.public_inputs[i].value if i in comp.public_inputs else 0
        arith = (g.q_m.value * a * b + g.q_l.value * a + g.q_r.value * b
                 + g.q_o.value * c + g.q_f.value * d + g.q_c.value)
        if (g.q_arith.value * arith + pi) % R:
            bad.append(i)
            continue
        nxt = (rows[i + 1] if i + 1 < len(rows) else zero_row)[1]
        ev = {"a": a, "b": b, "c": c, "d": d, "a_w": nxt[0], "b_w": nxt[1],
              "d_w": nxt[3], "q_l": g.q_l.value, "q_r": g.q_r.value,
              "q_c": g.q_c.value}
        for term, family in ref_plonk.WIDGETS:
            q = getattr(g, family).value
            if q and q * term(sep, ev) % R:
                bad.append(i)
                break
    return bad


def synthesize(circuit) -> Composer:
    comp = Composer.initialized()
    circuit.circuit(comp)
    return comp


@pytest.fixture(scope="module")
def full():
    """A transfer of the published shape, the composer that synthesized it
    (and the JubJub spans it opened), the reference's layout."""
    t = ref.make_pool(SEED, 4, 17, 1)[0]
    counts = dict(metrics.GLOBAL.counts)
    comp = synthesize(tx_circuit(t, 17))
    spans = {k: metrics.GLOBAL.counts[k] - counts.get(k, 0)
             for k in ("prove/jubjub_fixed_base",
                       "prove/jubjub_variable_base")}
    return t, comp, ref.transfer_layout(4, 17), spans


def test_the_layout_is_the_composers(full):
    t, comp, lay, spans = full
    assert len(comp.constraints) == len(lay.gates) == 126_302
    assert len(lay.gates) + 6 <= 1 << 17  # the compiler's 2^17 domain
    assert comp.public_input_indexes() == lay.public
    assert ([v.value for v in comp.public_input_values()]
            == ref.public_inputs(t))
    names = rc.SELECTORS
    for i, (g, q, family, wires) in enumerate(zip(
            comp.constraints, lay.gates, lay.families, lay.wires)):
        assert tuple(getattr(g, n).value for n in names) == q + family, i
        assert (g.a.index, g.b.index, g.c.index, g.d.index) == wires, i
    assert spans == {"prove/jubjub_fixed_base": 26,
                     "prove/jubjub_variable_base": 14}


def test_the_copy_constraint_cycles_are_the_layouts(full):
    _, comp, lay, _ = full
    uses = [[] for _ in range(lay.witnesses)]
    for gate, wires in enumerate(lay.wires):
        for kind, w in enumerate(wires):
            uses[w].append((kind, gate))
    assert len(comp.perm.witness_map) == lay.witnesses
    assert [[(wd.kind, wd.gate) for wd in m]
            for m in comp.perm.witness_map] == uses


def test_the_witness_satisfies_every_gate(full):
    _, comp, _, _ = full
    assert unsatisfied(comp) == []


def _wrong_u(t):
    n = t.inputs[0]
    n.signature = ((n.signature[0] + 1) % ORDER,) + n.signature[1:]


def _other_position(t):
    n = t.inputs[0]
    n.nullifier = ref.nullifier(n.note_pk_prime, n.pos + 1)


def _unbalanced(t):
    o = t.outputs[0]
    o.value += 1
    o.value_commitment = ref.value_commitment(o.value, o.blinder)


@pytest.mark.parametrize("fault", [None, _wrong_u, _other_position,
                                   _unbalanced],
                         ids=["sound", "u_off_by_one", "nullifier_of_another_"
                              "position", "values_do_not_balance"])
def test_a_wrong_witness_fails(fault):
    t = ref.make_pool(SEED + 1, 1, 1, 1)[0]
    if fault is not None:
        fault(t)
    bad = unsatisfied(synthesize(tx_circuit(t, 1)))
    assert bool(bad) == (fault is not None)
    if fault is _unbalanced:  # the balance's gate alone
        assert len(bad) == 1


# -- gadget circuits proven on the CPU -----------------------------------------
def host_commits(key, tensors, mesh=None, axis=None):
    """`commit_many_mont` through the native host MSM (the same points)."""
    from zkvm_tpu_torch.ops.limb_field import FR

    out = []
    for t in tensors:
        vals = FR.from_mont_array(t)
        x, y, inf = native_msm(key.powers_of_g[:len(vals)],
                               [Fr(v) for v in vals])
        out.append(Commitment(G1Affine.identity() if inf
                              else G1Affine(Fp(x), Fp(y))))
    return out


def quick_setup(log_n: int, seed: int) -> PublicParameters:
    """`PublicParameters.setup(2^log_n, StdRng(seed))` (the same draws, so
    the reference's `srs.trapdoor(seed)`), its powers of g taken one by
    one by the native host library."""
    rng = StdRng(seed)
    x = Fr.random(rng)
    g = (G1Affine.generator() * Fr.random(rng)).to_affine()
    powers = []
    for s in powers_of(x, (1 << log_n) + PublicParameters.ADDED_BLINDING_DEGREE):
        px, py, _ = native_msm([g], [s])
        powers.append(G1Affine(Fp(px), Fp(py)))
    h = (G2Affine.generator() * Fr.random(rng)).to_affine()
    return PublicParameters(CommitKey(powers, "cpu"),
                            OpeningKey(g, h, (h * x).to_affine()))


@pytest.fixture(scope="module")
def prove_cpu():
    """prove(circuit, layout, values): compile and prove `circuit` on the
    CPU; the proof's bytes, judged by the reference verifier against
    `layout` and the expected public `values`."""
    with pytest.MonkeyPatch.context() as mp:
        from zkvm_tpu_torch.plonk import kzg10

        mp.setattr(kzg10.CommitKey, "commit_many_mont", host_commits)
        pps = {}

        def prove(circuit, layout, values):
            log_n = (len(layout.gates) + 6 - 1).bit_length()
            if log_n not in pps:
                pps[log_n] = quick_setup(log_n, SEED)
            prover, verifier = Compiler.compile_with_circuit(
                pps[log_n], b"gadget", circuit)
            proof, pis = prover.prove(StdRng(SEED), circuit)
            verifier.verify(proof, pis)
            assert [v.value for v in pis] == values
            tau, g = ref_srs.trapdoor(SEED)
            vk = rc.verifier_key(layout, tau, g)
            raw = proof.to_bytes()
            public = dict(zip(layout.public, values))
            ref_plonk.verify(raw, public, vk, b"gadget", tau, g)
            bent = bytearray(raw)
            bent[-32] ^= 1
            with pytest.raises(ref_plonk.Rejected):
                ref_plonk.verify(bytes(bent), public, vk, b"gadget", tau, g)
        yield prove


class SignatureCircuit(Circuit):
    """A single Schnorr signature over a public message by a public key,
    and a range-checked value committed to a public point."""

    def __init__(self, rnd):
        sk, nonce = rnd.randrange(1, ORDER), rnd.randrange(1, ORDER)
        self.msg = rnd.randrange(R)
        self.pk = ref.mul(ref.G, sk)
        self.sig = ref.sign(sk, self.msg, nonce)
        self.value, self.blinder = rnd.randrange(1 << 64), rnd.randrange(ORDER)
        self.vc = ref.value_commitment(self.value, self.blinder)

    def circuit(self, c):
        m = c.append_public(Fr(self.msg))
        pk = c.append_public_point(point(self.pk))
        u, r = c.append_witness(JubjubFr(self.sig[0])), c.append_point(
            point(self.sig[1]))
        schnorr.verify_signature_gadget(c, u, r, pk, m)
        v = c.append_witness(self.value)
        b = c.append_witness(JubjubFr(self.blinder))
        c.assert_equal_public_point(notes.value_commitment_gadget(c, v, b),
                                    point(self.vc))

    def layout(self):
        lay = ref.TransferLayout()
        m = lay.public_witness()
        pk = lay.point()
        lay.assert_public_point(pk)
        lay.schnorr(lay.witness(), lay.point(), pk, m)
        v, b = lay.witness(), lay.witness()
        lay.assert_public_point(lay.value_commitment(v, b))
        return lay

    def values(self):
        return [self.msg, *self.pk, *self.vc]


class CommitmentCircuit(Circuit):
    """A range-checked value committed to a public point, and a public
    message truncated to 250 bits by the logic gadget (as a truncated hash
    is): every gate family (arithmetic, range, logic, fixed-base, curve
    addition) in a 2^10 domain."""

    def __init__(self, rnd):
        self.msg = rnd.randrange(R)
        self.value, self.blinder = rnd.randrange(1 << 64), rnd.randrange(ORDER)
        self.vc = ref.value_commitment(self.value, self.blinder)

    def circuit(self, c):
        m = c.append_public(Fr(self.msg))
        v = c.append_witness(self.value)
        b = c.append_witness(JubjubFr(self.blinder))
        vc = notes.value_commitment_gadget(c, v, b)
        c.assert_equal_public_point(vc, point(self.vc))
        low = c.append_logic_xor(m, Composer.ZERO, 125)
        c.assert_equal_constant(low, Fr.zero(), Fr(self.msg & ref.TRUNCATION))

    def layout(self):
        lay = ref.TransferLayout()
        m = lay.public_witness()
        v, b = lay.witness(), lay.witness()
        lay.assert_public_point(lay.value_commitment(v, b))
        lay.assert_public(lay.logic(m, rc.ZERO, 125, xor=True))
        return lay

    def values(self):
        return [self.msg, *self.vc, self.msg & ref.TRUNCATION]


class DoubleSignatureCircuit(Circuit):
    def __init__(self, rnd):
        sk, nonce = rnd.randrange(1, ORDER), rnd.randrange(1, ORDER)
        self.msg = rnd.randrange(R)
        self.pk = ref.mul(ref.G, sk)
        self.pk_prime = ref.mul(ref.G_NUMS, sk)
        self.sig = ref.sign_double(sk, self.msg, nonce)

    def circuit(self, c):
        m = c.append_public(Fr(self.msg))
        pk = c.append_public_point(point(self.pk))
        pk_prime = c.append_public_point(point(self.pk_prime))
        u = c.append_witness(JubjubFr(self.sig[0]))
        r, r_prime = c.append_point(point(self.sig[1])), c.append_point(
            point(self.sig[2]))
        schnorr.verify_signature_double_gadget(c, u, r, r_prime, pk,
                                               pk_prime, m)

    def layout(self):
        lay = ref.TransferLayout()
        m = lay.public_witness()
        pk = lay.point()
        lay.assert_public_point(pk)
        pk_prime = lay.point()
        lay.assert_public_point(pk_prime)
        u = lay.witness()
        lay.schnorr_double(u, lay.point(), lay.point(), pk, pk_prime, m)
        return lay

    def values(self):
        return [self.msg, *self.pk, *self.pk_prime]


class ElgamalCircuit(Circuit):
    """A witnessed point encrypted under a witnessed key, the ciphertext
    public."""

    def __init__(self, rnd):
        self.pk = ref.mul(ref.G, rnd.randrange(1, ORDER))
        self.message = ref.mul(ref.G, rnd.randrange(1, ORDER))
        self.r = rnd.randrange(1, ORDER)
        self.cipher = ref.encrypt(self.pk, self.message, self.r)

    def circuit(self, c):
        pk, msg = c.append_point(point(self.pk)), c.append_point(
            point(self.message))
        gamma, delta = notes.encrypt_gadget(c, pk, msg,
                                            c.append_witness(JubjubFr(self.r)))
        c.assert_equal_public_point(gamma, point(self.cipher[0]))
        c.assert_equal_public_point(delta, point(self.cipher[1]))

    def layout(self):
        lay = ref.TransferLayout()
        pk, msg = lay.point(), lay.point()
        gamma, delta = lay.encrypt(pk, msg, lay.witness())
        lay.assert_public_point(gamma)
        lay.assert_public_point(delta)
        return lay

    def values(self):
        return [*self.cipher[0], *self.cipher[1]]


class NoteCircuit(Circuit):
    """A note's hash opened to a public root of a height-1 tree, and its
    nullifier public."""

    def __init__(self, rnd):
        t = ref.make_pool(rnd.randrange(1 << 32), 1, 1, 1)[0]
        self.t, self.note = t, t.inputs[0]
        self.vc = ref.value_commitment(self.note.value, self.note.blinder)

    def circuit(self, c):
        n = self.note
        root = c.append_public(Fr(self.t.root))
        note_type, pos = c.append_witness(n.note_type), c.append_witness(n.pos)
        vc, pk = c.append_point(point(self.vc)), c.append_point(point(n.note_pk))
        pk_prime = c.append_point(point(n.note_pk_prime))
        leaf = notes.note_hash_gadget(c, note_type, vc, pk, pos)
        opening = poseidon_opening_from_slice(ref_merkle.opening_bytes(
            self.t.root, n.branch, n.positions), 1)
        c.assert_equal(opening_gadget(c, opening, leaf), root)
        c.assert_equal_constant(notes.nullifier_gadget(c, pk_prime, pos),
                                Fr.zero(), Fr(n.nullifier))

    def layout(self):
        lay = ref.TransferLayout()
        root = lay.public_witness()
        note_type, pos = lay.witness(), lay.witness()
        vc, pk, pk_prime = lay.point(), lay.point(), lay.point()
        leaf = lay.hash_segments([[note_type], list(vc), list(pk), [pos]])
        lay.assert_equal(lay.opening(1, leaf), root)
        lay.assert_public(lay.hash_segments([list(pk_prime), [pos]]))
        return lay

    def values(self):
        return [self.t.root, self.note.nullifier]


def _prove_gadget(prove_cpu, cls):
    circuit = cls(random.Random(f"{SEED}-{cls.__name__}"))
    layout = circuit.layout()
    assert len(synthesize(circuit).constraints) == len(layout.gates)
    prove_cpu(circuit, layout, circuit.values())


def test_a_commitment_and_truncation_proof_is_accepted(prove_cpu):
    _prove_gadget(prove_cpu, CommitmentCircuit)


@pytest.mark.slow
@pytest.mark.parametrize("cls", [SignatureCircuit, DoubleSignatureCircuit,
                                 ElgamalCircuit, NoteCircuit],
                         ids=lambda c: c.__name__)
def test_a_larger_gadget_proof_is_accepted(prove_cpu, cls):
    _prove_gadget(prove_cpu, cls)
