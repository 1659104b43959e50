"""zkvm_tpu_torch.ops.g1_ops and the padd kernel's plain version against
zkvm_tpu.ops.g1_ops and the Pallas kernel it replaces.

Inputs are numpy-seeded multiples of the generator plus identity and
doubling lanes; coordinates are compared bit for bit after the layout
conversion (exact arithmetic, tolerance zero).  Points are made with the
port's host classes and handed to the reference through their coordinates.
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu_torch.curves.g1 import G1Affine, G1Projective
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu.ops import g1_ops as rg1
from zkvm_tpu.ops import pallas_field
from zkvm_tpu_torch.ops import g1_ops, kernels
from zkvm_tpu_torch.ops import limb_field as lf

torch.set_num_threads(1)


def _points(n, seed):
    """n affine points A + i*S for numpy-seeded multiples A, S of G."""
    rng = np.random.default_rng(seed)
    g = G1Projective.generator()
    a = g * int(rng.integers(1, 1 << 62))
    s = g * int(rng.integers(1, 1 << 62))
    out = []
    for _ in range(n):
        out.append(a)
        a = a + s
    return G1Projective.batch_normalize(out)


def _both(points):
    """The same points as reference and port device triples."""
    ref = rg1.affine_to_device(
        [RG1Affine.identity() if p.infinity
         else RG1Affine(RFp(p.x.value), RFp(p.y.value)) for p in points])
    port = tuple(lf.from_reference(np.asarray(t), lf.FQ, "cpu") for t in ref)
    return ref, port


def _same(port, ref):
    return all((lf.to_reference(p, lf.FQ) == np.asarray(r)).all()
               for p, r in zip(port, ref))


def test_affine_to_device_matches_reference():
    pts = _points(9, 1) + [G1Affine.identity()]
    ref, _ = _both(pts)
    port = g1_ops.affine_to_device(pts, "cpu")
    assert _same(port, ref)
    for i, p in enumerate(pts):
        assert g1_ops.device_to_projective(port, i) == p.to_projective()


@pytest.fixture(scope="module")
def pq():
    """130 lanes (crosses the 128-lane block): random sums, then identity
    operands, P + P and P + (-P)."""
    lhs = _points(130, 2)
    rhs = _points(130, 3)
    lhs[0] = G1Affine.identity()
    rhs[1] = G1Affine.identity()
    lhs[2] = rhs[2] = G1Affine.identity()
    rhs[3] = lhs[3]
    rhs[4] = -lhs[4]
    return _both(lhs), _both(rhs)


def test_padd_matches_reference(pq):
    (rp, pp), (rq, pq_) = pq
    assert _same(g1_ops.padd(pp, pq_), rg1._padd_jnp(rp, rq))


def test_padd_plain_matches_pallas_interpret(pq):
    (rp, pp), (rq, pq_) = pq
    want = pallas_field.padd_pallas_2l(rp, rq, block=128, interpret=True)
    assert _same(kernels.padd_plain(pp, pq_), want)


def test_pdouble_matches_reference(pq):
    (rp, pp), _ = pq
    got = g1_ops.pdouble(pp)
    assert _same(got, rg1._pdouble_jnp(rp))
    # the complete addition doubles to the same group element
    twice = g1_ops.padd(pp, pp)
    for i in (0, 5, 129):
        assert (g1_ops.device_to_projective(got, i)
                == g1_ops.device_to_projective(twice, i))


def test_pneg_pselect_identity(pq):
    (rp, pp), (rq, pq_) = pq
    assert _same(g1_ops.pneg(pp), rg1.pneg(rp))
    mask = np.arange(130) % 3 == 0
    got = g1_ops.pselect(torch.as_tensor(mask), pp, pq_)
    assert _same(got, rg1.pselect(mask, rp, rq))
    assert _same(g1_ops.identity_batch((2, 5), "cpu"),
                 rg1.identity_batch((2, 5)))


def test_batch_scalar_mul_base_matches_host():
    rng = np.random.default_rng(5)
    base = _points(1, 5)[0]
    scalars = [Fr(int(v)) for v in rng.integers(1, 1 << 62, 13)]
    scalars += [Fr.zero(), Fr.one(), Fr(Fr.MODULUS - 1), Fr(1 << 255)]
    got = g1_ops.batch_scalar_mul_base(base, scalars, "cpu")
    assert got == [(base * s).to_affine() for s in scalars]
