"""The port's own host layer against zkvm_tpu's, value for value.

zkvm_tpu_torch keeps copies of `params`, `fields`, `curves`, `rng`,
`serialize`, `native` and `hashes`.  The two packages' classes are different types, so
every comparison here goes through Python ints or canonical bytes: the same
numpy-seeded inputs enter both packages and the same integers or bytes must
come out.  Exact equality throughout.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

import zkvm_tpu.curves.g1 as rg1
import zkvm_tpu.curves.g2 as rg2
import zkvm_tpu.curves.hash_to_curve as rh2c
import zkvm_tpu.curves.jubjub as rjubjub
import zkvm_tpu.curves.msm as rmsm
import zkvm_tpu.fields as rfields
import zkvm_tpu.hashes as rhashes
import zkvm_tpu.hashes.safe as rsafe
import zkvm_tpu.native as rnative
import zkvm_tpu.rng as rrng
import zkvm_tpu.serialize as rserialize
import zkvm_tpu_torch.curves.g1 as pg1
import zkvm_tpu_torch.curves.g2 as pg2
import zkvm_tpu_torch.curves.hash_to_curve as ph2c
import zkvm_tpu_torch.curves.jubjub as pjubjub
import zkvm_tpu_torch.curves.msm as pmsm
import zkvm_tpu_torch.fields as pfields
import zkvm_tpu_torch.hashes as phashes
import zkvm_tpu_torch.hashes.safe as psafe
import zkvm_tpu_torch.native as pnative
import zkvm_tpu_torch.params as pparams
import zkvm_tpu_torch.rng as prng
import zkvm_tpu_torch.serialize as pserialize

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_poseidon import GOLDEN, TEST_INPUTS  # noqa: E402

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
                                  "curves.h2c_g2_constants",
                                  "hashes.poseidon_constants"])
def test_constants_equal(name):
    ref = _constants(importlib.import_module("zkvm_tpu." + name))
    port = _constants(importlib.import_module("zkvm_tpu_torch." + name))
    assert ref and ref == port


@pytest.mark.parametrize("cls", ["Fr", "Fp", "JubjubFr"])
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


def test_jubjub_fr_windowed_naf_equal():
    out = []
    for fields in (rfields, pfields):
        out.append([fields.JubjubFr(v).compute_windowed_naf(w)
                    for v in [0, 1, fields.JubjubFr.MODULUS - 1] + _ints(3, 6)
                    for w in (2, 5)])
    assert out[0] == out[1]


def test_jubjub_group_law_and_encodings_equal():
    ks = [0, 1, 2, pparams.JUBJUB_FR_MODULUS - 1] + _ints(3, 7, 250)
    out = []
    for fields, jj in ((rfields, rjubjub), (pfields, pjubjub)):
        g = jj.JubjubExtended.generator()
        pts = [g * fields.JubjubFr(k) for k in ks]
        affine = jj.JubjubExtended.batch_normalize(pts)
        enc = [a.to_bytes() for a in affine]
        back = [jj.JubjubAffine.from_bytes(e).to_bytes() for e in enc]
        total = jj.JubjubExtended.identity()
        for p in pts:
            total = total + p
        niels = jj.ExtendedNielsPoint(pts[4]).add_to(pts[5])
        secret = fields.JubjubFr(ks[5])
        cipher = jj.ElgamalCipher.encrypt(secret, pts[4],
                                          jj.JubjubExtended.generator_nums(),
                                          pts[6])
        out.append((enc, back, total.to_affine().to_bytes(),
                    (pts[4] - pts[5]).to_affine().to_bytes(),
                    pts[6].double().to_affine().to_bytes(),
                    niels.to_affine().to_bytes(),
                    [p.is_torsion_free() and p.is_on_curve() for p in pts],
                    [h.value for h in pts[5].to_hash_inputs()],
                    jj.dhke(secret, pts[6]).to_bytes(),
                    cipher.to_bytes(),
                    jj.ElgamalCipher.from_bytes(cipher.to_bytes())
                    .decrypt(secret).to_affine().to_bytes(),
                    jj.hash_to_point(b"zkvm").to_affine().to_bytes(),
                    jj.JubjubAffine.from_bytes(b"\xff" * 32)))
    assert out[0] == out[1]
    assert out[1][0][0] == pjubjub.JubjubAffine.identity().to_bytes()


def test_jubjub_map_to_point_round_trip_equal():
    values = [0, 1, (1 << 64) - 1] + [v & ((1 << 64) - 1)
                                      for v in _ints(3, 8)]
    out = []
    for jj in (rjubjub, pjubjub):
        pts = [jj.map_to_point(v) for v in values]
        assert [jj.unmap_from_point(p) for p in pts] == values
        assert all(p.is_torsion_free() for p in pts)
        out.append([p.to_affine().to_bytes() for p in pts])
    assert out[0] == out[1]


def test_hash_to_curve_g1_and_g2_equal():
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    dst2 = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
    out = []
    for h2c in (rh2c, ph2c):
        got = []
        for msg in (b"", b"abc", bytes(range(200))):
            got.append((h2c.expand_message_xmd(msg, dst, 96),
                        h2c.expand_message_xof(msg, dst, 48),
                        [f.value for f in h2c.hash_to_field(msg, dst, 2)],
                        [s.value for s in
                         h2c.hash_to_scalar_field(msg, dst, 2)],
                        h2c.hash_to_curve_g1(msg, dst).to_affine().to_bytes(),
                        h2c.encode_to_curve_g1(msg, dst).to_affine()
                        .to_bytes(),
                        h2c.hash_to_curve_g2(msg, dst2).to_affine()
                        .to_bytes(),
                        h2c.encode_to_curve_g2(msg, dst2).to_affine()
                        .to_bytes()))
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("domain,sizes,n_out", [
    ("Merkle4", (4,), 1), ("Merkle2", (2,), 1), ("Encryption", (3, 2), 1),
    ("Other", (1,), 1), ("Other", (5, 4), 3), ("Other", (9,), 6)])
def test_poseidon_hash_equal_over_every_domain(domain, sizes, n_out):
    out = []
    for fields, hashes in ((rfields, rhashes), (pfields, phashes)):
        vals = [0, fields.Fr.MODULUS - 1] + _ints(sum(sizes), 9)
        h = hashes.Hash(getattr(hashes.Domain, domain))
        h.output_len(n_out)
        for size in sizes:
            h.update([fields.Fr(v) for v in vals[:size]])
            vals = vals[size:]
        out.append(([f.value for f in h.finalize()],
                    [(type(f).__name__, f.value)
                     for f in h.finalize_truncated()]))
    assert out[0] == out[1]
    assert len(out[1][0]) == (n_out if domain == "Other" else 1)


@pytest.mark.parametrize("n", sorted(GOLDEN))
def test_poseidon_golden_digests(n):
    """The reference suite's known answers (coset-poseidon/src/hades.rs:
    73-142, transcribed in tests/test_poseidon.py) on the port's copy of
    `hashes`: a sponge with the tag stubbed to zero over the first n test
    inputs, then a one."""

    class ZeroTagPermutation(phashes.ScalarPermutation):
        def tag(self, data: bytes):
            return pfields.Fr.zero()

    inputs = [pfields.Fr.from_hex_str(s) for s in TEST_INPUTS[:n]]
    io = [psafe.Call.absorb(n), psafe.Call.absorb(1), psafe.Call.squeeze(1)]
    sponge = psafe.Sponge.start(ZeroTagPermutation(), io, 0)
    sponge.absorb(n, inputs)
    sponge.absorb(1, [pfields.Fr.one()])
    sponge.squeeze(1)
    assert repr(sponge.finish()[0]) == GOLDEN[n]


def test_hades_permutation_equal():
    out = []
    for hashes in (rhashes, phashes):
        states = [[0] * 5, [pparams.FR_MODULUS - 1] * 5, _ints(5, 10)]
        out.append([hashes.hades_permute([v % pparams.FR_MODULUS for v in s])
                    for s in states])
    assert out[0] == out[1] and hashes.WIDTH == 5


@pytest.mark.parametrize("fields,hashes,safe", [
    (rfields, rhashes, rsafe), (pfields, phashes, psafe)],
    ids=["reference", "port"])
def test_sponge_misuse_raises(fields, hashes, safe):
    """The io pattern is enforced: a wrong call kind, a call across a
    boundary, a call past the end, an early finish, a call after finish and
    the fixed shapes of the Merkle domains."""
    one = fields.Fr.one()
    perm = hashes.ScalarPermutation()
    pattern = [hashes.Call.absorb(2), hashes.Call.squeeze(1)]

    def sponge():
        return hashes.Sponge.start(perm, pattern, 0)

    s = sponge()
    with pytest.raises(safe.IOPatternViolation):
        s.squeeze(1)                       # expected absorb
    s = sponge()
    with pytest.raises(safe.IOPatternViolation):
        s.absorb(3, [one] * 3)             # spans the io boundary
    s = sponge()
    s.absorb(2, [one, one])
    with pytest.raises(safe.IOPatternViolation):
        s.finish()                         # pattern not complete
    s.squeeze(1)
    with pytest.raises(safe.IOPatternViolation):
        s.squeeze(1)                       # pattern exhausted
    assert len(s.finish()) == 1
    with pytest.raises(safe.IOPatternViolation):
        s.absorb(1, [one])                 # already finished
    for domain, n in ((hashes.Domain.Merkle4, 3), (hashes.Domain.Merkle2, 4)):
        with pytest.raises(safe.IOPatternViolation):
            hashes.Hash.digest(domain, [one] * n)
    merged = safe.aggregate_io_pattern(
        [hashes.Call.absorb(1), hashes.Call.absorb(2), hashes.Call.squeeze(1)])
    assert [(c.kind, c.len) for c in merged] == [
        (safe.CallKind.ABSORB, 3), (safe.CallKind.SQUEEZE, 1)]
