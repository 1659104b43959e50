"""The port's own host layer against zkvm_tpu's, value for value.

zkvm_tpu_torch keeps copies of `params`, `fields`, `curves`, `rng`,
`serialize` and `native`.  The two packages' classes are different types, so
every comparison here goes through Python ints or canonical bytes: the same
numpy-seeded inputs enter both packages and the same integers or bytes must
come out.  Exact equality throughout.
"""

import importlib

import numpy as np
import pytest

import zkvm_tpu.curves.g1 as rg1
import zkvm_tpu.curves.g2 as rg2
import zkvm_tpu.curves.msm as rmsm
import zkvm_tpu.fields as rfields
import zkvm_tpu.native as rnative
import zkvm_tpu.rng as rrng
import zkvm_tpu.serialize as rserialize
import zkvm_tpu_torch.curves.g1 as pg1
import zkvm_tpu_torch.curves.g2 as pg2
import zkvm_tpu_torch.curves.msm as pmsm
import zkvm_tpu_torch.fields as pfields
import zkvm_tpu_torch.native as pnative
import zkvm_tpu_torch.params as pparams
import zkvm_tpu_torch.rng as prng
import zkvm_tpu_torch.serialize as pserialize

# `curves.pairing` as an attribute is the function of that name
rpairing = importlib.import_module("zkvm_tpu.curves.pairing")
ppairing = importlib.import_module("zkvm_tpu_torch.curves.pairing")

PACKAGES = [(rfields, rg1, rg2, rmsm, rpairing, rnative),
            (pfields, pg1, pg2, pmsm, ppairing, pnative)]


def _ints(n, seed, bits=255):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 7), dtype=np.uint64).tolist()
    return [sum(int(w) << (63 * k) for k, w in enumerate(row))
            & ((1 << bits) - 1) for row in words]


def _constants(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, (int, bool, tuple, list, bytes))}


@pytest.mark.parametrize("name", ["params", "curves.h2c_constants",
                                  "curves.h2c_g2_constants"])
def test_constants_equal(name):
    ref = _constants(importlib.import_module("zkvm_tpu." + name))
    port = _constants(importlib.import_module("zkvm_tpu_torch." + name))
    assert ref and ref == port


@pytest.mark.parametrize("cls", ["Fr", "Fp"])
def test_prime_field_ops_equal(cls):
    """add, sub, mul, neg, inverse, square root, pow and the byte encodings,
    with 0, 1 and p - 1 among the operands."""
    out = []
    for fields in (rfields, pfields):
        f = getattr(fields, cls)
        vals = [0, 1, f.MODULUS - 1] + _ints(13, 1, 381)
        xs = [f(v) for v in vals]
        got = []
        for a, b in zip(xs, xs[1:] + xs[:1]):
            root = a.square().sqrt()
            got.append(((a + b).value, (a - b).value, (a * b).value,
                        (-a).value, a.square().value, a.pow(b.value).value,
                        None if a.is_zero() else a.invert().value,
                        None if root is None else root.square().value,
                        a.to_bytes(),
                        f.from_bytes(a.to_bytes()).value))
        out.append(got)
    assert out[0] == out[1]


def test_fr_random_and_rng_streams_equal():
    streams = []
    for fields, rng in ((rfields, rrng), (pfields, prng)):
        r = rng.StdRng(42)
        streams.append((r.randbytes(70), r.next_u32(), r.next_u64(),
                        [fields.Fr.random(r).value for _ in range(5)],
                        rng.seed_from_u64(7),
                        rng.ChaChaRng.seed_from_u64(9, 20).randbytes(65)))
    assert streams[0] == streams[1]


def test_serialize_round_trip_equal():
    out = []
    for fields, ser in ((rfields, rserialize), (pfields, pserialize)):
        w = ser.Writer()
        w.write_u32_le(0xDEADBEEF)
        w.write_u64_le(0x0123456789ABCDEF)
        w.write_obj(fields.Fr(12345))
        buf = w.getvalue()
        r = ser.Reader(buf)
        out.append((buf, r.read_u32_le(), r.read_u64_le(),
                    r.read_obj(fields.Fr).value, r.remaining(),
                    ser.hex_str(fields.Fr(77)),
                    ser.from_hex_str(fields.Fr,
                                     ser.hex_str(fields.Fr(77))).value))
        with pytest.raises(ser.BadLength):
            ser.Reader(b"\x00").read(2)
    assert out[0] == out[1]


def test_g1_scalar_multiplication_and_encodings_equal():
    ks = [0, 1, 2, pparams.FR_MODULUS - 1] + _ints(4, 2)
    out = []
    for fields, g1, *_ in PACKAGES:
        g = g1.G1Projective.generator()
        pts = [(g * fields.Fr(k)).to_affine() for k in ks]
        total = g1.G1Projective.identity()
        for p in pts:
            total = total + p.to_projective()
        enc = [(p.to_bytes(), p.to_uncompressed()) for p in pts]
        back = [g1.G1Affine.from_bytes(c).to_bytes() for c, _ in enc]
        norm = [p.to_bytes() for p in g1.G1Projective.batch_normalize(
            [g * 5, g1.G1Projective.identity(), g.double()])]
        out.append((enc, back, norm, total.to_affine().to_bytes(),
                    (-pts[4]).to_bytes(),
                    g1.G1Affine.from_bytes(b"\x01" * 48)))
    assert out[0] == out[1]


def test_g2_scalar_multiplication_psi_and_encodings_equal():
    ks = [0, 1, pparams.FR_MODULUS - 1] + _ints(2, 3)
    out = []
    for fields, _, g2, *_ in PACKAGES:
        g = g2.G2Projective.generator()
        pts = [(g * fields.Fr(k)).to_affine() for k in ks]
        enc = [(p.to_bytes(), p.to_uncompressed()) for p in pts]
        back = [g2.G2Affine.from_bytes(c).to_bytes() for c, _ in enc]
        q = pts[3].to_projective()
        out.append((enc, back,
                    (q + g.double()).to_affine().to_bytes(),
                    q.psi().to_affine().to_bytes(),
                    q.psi2().to_affine().to_bytes(),
                    q.clear_cofactor().to_affine().to_bytes(),
                    pts[4].is_torsion_free(), pts[4].is_on_curve()))
    assert out[0] == out[1]


def _msm_inputs(fields, g1, n):
    g = g1.G1Projective.generator()
    a, s = g * 0x1234567, g * 0x7654321
    pts = []
    for _ in range(n):
        pts.append(a)
        a = a + s
    pts = g1.G1Projective.batch_normalize(pts)
    pts[3] = g1.G1Affine.identity()
    pts[5] = pts[4]
    scalars = [fields.Fr(v) for v in _ints(n, 4)]
    scalars[:3] = [fields.Fr.zero(), fields.Fr.one(),
                   fields.Fr(fields.Fr.MODULUS - 1)]
    return pts, scalars


def test_host_msm_equal():
    """msm_variable_base, msm_host (which takes the native library where it
    builds), pippenger and native_msm on the same 70 points and scalars."""
    out = []
    for fields, g1, _, msm, _, native in PACKAGES:
        pts, scalars = _msm_inputs(fields, g1, 70)
        out.append((msm.msm_variable_base(pts, scalars).to_affine().to_bytes(),
                    msm.msm_host(pts, scalars).to_affine().to_bytes(),
                    msm.pippenger(list(zip(pts, scalars)))
                    .to_affine().to_bytes(),
                    native.native_msm(pts, scalars)))
    assert out[0] == out[1]
    assert out[1][0] == out[1][1] == out[1][2]


def test_pairing_equal_and_bilinear():
    """e(aG1, bG2) as twelve Fp coefficients, by the fast tower and by the
    class tower, and the native pairing check of e(aP, Q) e(-P, aQ) = 1."""
    a, b = _ints(2, 5)
    out = []
    for fields, g1, g2, _, pairing, native in PACKAGES:
        p = (g1.G1Projective.generator() * fields.Fr(a)).to_affine()
        q = (g2.G2Projective.generator() * fields.Fr(b)).to_affine()
        terms = [(p, pairing.G2Prepared(q))]
        fast = pairing.pairing(p, q)
        ml_ref = pairing.multi_miller_loop_ref(terms)
        assert pairing._fp12_to_tuple(ml_ref) == pairing._fp12_to_tuple(
            pairing.multi_miller_loop(terms))
        slow = pairing.final_exponentiation_ref(ml_ref)
        assert fast == slow
        pa = (p.to_projective() * fields.Fr(a)).to_affine()
        qa = (q.to_projective() * fields.Fr(a)).to_affine()
        checks = []
        for t in ([(pa, q), (-p, qa)], [(pa, q), (-p, q)]):
            checks.append(pairing.final_exponentiation(
                pairing.multi_miller_loop(
                    [(g, pairing.G2Prepared(h)) for g, h in t])).is_identity())
            checks.append(native.native_pairing_check(t))
        out.append((pairing._fp12_to_tuple(fast.value), checks))
    assert out[0] == out[1]
    assert out[1][1] == [True, True, False, False]
