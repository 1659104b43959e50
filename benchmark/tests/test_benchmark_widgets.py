"""The reference against the program on a circuit with every gate family
the composer has, on the CPU at a 2^12 domain: a 64-bit range proof, a
32-bit AND and XOR, a truncated hash (its XOR over 125 bit pairs),
fixed-base multiplications of a seeded JubJub scalar by the generator and
by the NUMS generator, their sum (the variable-base gate), a
variable-base multiplication by the truncated hash, and the sum set equal
to a public point.  The circuit is written twice, once with the program's
`Composer` and once as a reference `Layout`."""

from __future__ import annotations

import random

import pytest

from benchmark.reference import circuit as rc
from benchmark.reference import curve, jubjub, plonk, srs
from benchmark.reference.field import R
from zkvm_tpu_torch.curves.jubjub import JubjubAffine, JubjubExtended
from zkvm_tpu_torch.fields import Fr, JubjubFr
from zkvm_tpu_torch.hashes.gadget import HashGadget
from zkvm_tpu_torch.hashes.poseidon import Domain
from zkvm_tpu_torch.plonk.composer import Circuit, Composer

SRS_SEED = 11
LABEL = b"widget-circuit"
NAMES = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith", "q_range",
         "q_logic", "q_fixed_group_add", "q_variable_group_add")


def inputs(seed: int) -> dict:
    rnd = random.Random(seed)
    s = rnd.randrange(jubjub.ORDER)
    return {"x": rnd.randrange(1 << 64), "a": rnd.randrange(1 << 32),
            "b": rnd.randrange(1 << 32), "s": s,
            "point": jubjub.mul(jubjub.GENERATOR, rnd.randrange(jubjub.ORDER)),
            "public": jubjub.add(jubjub.mul(jubjub.GENERATOR, s),
                                 jubjub.mul(jubjub.GENERATOR_NUMS, s))}


class WidgetCircuit(Circuit):
    def __init__(self, v: dict):
        self.v = v

    def circuit(self, c: Composer) -> None:
        v = self.v
        x = c.append_witness(v["x"])
        c.component_range(x, 32)
        a, b = c.append_witness(v["a"]), c.append_witness(v["b"])
        c.append_logic_and(a, b, 16)
        c.append_logic_xor(a, b, 16)
        h = HashGadget.digest_truncated(c, Domain.Other, [x, a, b])[0]
        s = c.append_witness(JubjubFr(v["s"]))
        p = c.component_mul_generator(s, JubjubAffine.generator())
        q = c.component_mul_generator(s, JubjubAffine.generator_nums())
        r = c.component_add_point(p, q)
        point = c.append_point(JubjubAffine(Fr(v["point"][0]),
                                            Fr(v["point"][1])))
        c.component_mul_point(h, point)
        c.assert_equal_public_point(r, JubjubAffine(Fr(v["public"][0]),
                                                    Fr(v["public"][1])))


def widget_layout() -> rc.Layout:
    lay = rc.Layout()
    x = lay.witness()
    lay.range(x, 32)
    a, b = lay.witness(), lay.witness()
    lay.logic(a, b, 16, xor=False)
    lay.logic(a, b, 16, xor=True)
    h = lay.hash_truncated([x, a, b])
    s = lay.witness()
    p = lay.mul_generator(s, jubjub.GENERATOR)
    q = lay.mul_generator(s, jubjub.GENERATOR_NUMS)
    r = lay.add_point(p, q)
    lay.mul_point(h, lay.point())
    lay.assert_public(r[0])
    lay.assert_public(r[1])
    return lay


@pytest.fixture(scope="module")
def proven(fast_commits):
    """(verifier, proof bytes, public values) of one proof of the circuit,
    compiled under StdRng(SRS_SEED)'s setup."""
    from zkvm_tpu_torch.plonk import Compiler, PublicParameters
    from zkvm_tpu_torch.rng import StdRng

    v = inputs(3)
    pp = PublicParameters.setup(1 << 12, StdRng(SRS_SEED), "cpu")
    prover, verifier = Compiler.compile_with_circuit(pp, LABEL,
                                                     WidgetCircuit(inputs(0)))
    proof, pis = prover.prove(StdRng(21), WidgetCircuit(v))
    verifier.verify(proof, pis)
    assert [pi.value for pi in pis] == list(v["public"])
    return verifier, proof.to_bytes(), list(v["public"])


def test_layout_is_the_composers():
    comp = Composer.initialized()
    WidgetCircuit(inputs(1)).circuit(comp)
    lay = widget_layout()
    assert 2 ** 11 < len(lay.gates) <= 2 ** 12
    assert len(lay.gates) == len(comp.constraints)
    assert lay.witnesses == len(comp.witnesses)
    assert lay.public == comp.public_input_indexes()
    for k, (g, q, family, w) in enumerate(zip(comp.constraints, lay.gates,
                                              lay.families, lay.wires)):
        assert tuple(getattr(g, n).value for n in NAMES) == q + family, k
        assert (g.a.index, g.b.index, g.c.index, g.d.index) == w, k
    used = {f for f in lay.families}
    assert {rc.ARITH, rc.NONE, rc.RANGE, rc.FIXED_BASE, rc.VARIABLE_BASE,
            (0, 0, 1, 0, 0), (0, 0, R - 1, 0, 0)} == used


def test_verifier_key_is_the_compilers(proven):
    verifier, _, _ = proven
    tau, g = srs.trapdoor(SRS_SEED)
    vk = rc.verifier_key(widget_layout(), tau, g)
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
        assert vk[name] is not None, name
        assert curve.to_bytes(vk[name]) == comm.to_bytes(), name


@pytest.fixture(scope="module")
def judged(proven):
    """(proof bytes, public inputs by gate, the reference's key, tau, g)."""
    _, raw, values = proven
    tau, g = srs.trapdoor(SRS_SEED)
    lay = widget_layout()
    return raw, dict(zip(lay.public, values)), rc.verifier_key(lay, tau, g), \
        tau, g


def test_reference_judges_the_programs_proof(proven, judged):
    _, raw, values = proven
    _, public, vk, tau, g = judged
    lay = widget_layout()
    plonk.verify(raw, public, vk, LABEL, tau, g)
    # each of the 15 evaluations altered (each also moves the transcript's
    # challenges, so this alone does not show that a widget's term counts)
    for k, name in enumerate(plonk.EVALUATIONS):
        bad = bytearray(raw)
        bad[48 * len(plonk.COMMITMENTS) + 32 * k] ^= 1
        with pytest.raises(plonk.Rejected):
            plonk.verify(bytes(bad), public, vk, LABEL, tau, g)
    with pytest.raises(plonk.Rejected):
        plonk.verify(raw, {**public, lay.public[1]: (values[1] + 1) % R}, vk,
                     LABEL, tau, g)
    fixed = lay.families.index(rc.FIXED_BASE) + 7
    q = list(lay.gates[fixed])
    q[1] = (q[1] + 1) % R
    lay.gates[fixed] = tuple(q)
    with pytest.raises(plonk.Rejected):
        plonk.verify(raw, public, rc.verifier_key(lay, tau, g), LABEL, tau, g)


@pytest.mark.parametrize("broken", ["dropped", "off_by_one"])
@pytest.mark.parametrize("family", range(len(plonk.WIDGETS)))
def test_each_widget_term_counts(judged, monkeypatch, family, broken):
    """The sound proof is rejected once one family's linearisation term is
    left out or one off: the challenges are untouched, so only the term
    itself can fail it, and a term that the reference lost or broke would
    pass a proof that leaves the family's constraints unchecked."""
    raw, public, vk, tau, g = judged
    term, selector = plonk.WIDGETS[family]
    assert vk[selector] is not None  # the circuit uses the family

    def wrong(sep, ev):
        return 0 if broken == "dropped" else (term(sep, ev) + 1) % R
    widgets = list(plonk.WIDGETS)
    widgets[family] = (wrong, selector)
    monkeypatch.setattr(plonk, "WIDGETS", tuple(widgets))
    with pytest.raises(plonk.Rejected):
        plonk.verify(raw, public, vk, LABEL, tau, g)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jubjub_is_the_programs(seed):
    rnd = random.Random(seed)
    j, k = rnd.randrange(jubjub.ORDER), rnd.randrange(1 << 256)
    for base, pbase in ((jubjub.GENERATOR, JubjubExtended.generator()),
                        (jubjub.GENERATOR_NUMS,
                         JubjubExtended.generator_nums())):
        p, pp = jubjub.mul(base, j), pbase * JubjubFr(j)
        q, pq = jubjub.mul(base, k), pbase * k
        for ours, theirs in ((p, pp), (q, pq), (jubjub.add(p, q), pp + pq),
                             (jubjub.double(p), pp.double()),
                             (jubjub.neg(q), -pq)):
            affine = theirs.to_affine()
            assert ours == (affine.u.value, affine.v.value)
            assert jubjub.on_curve(ours)
    assert jubjub.mul(jubjub.GENERATOR, jubjub.ORDER) == jubjub.IDENTITY
