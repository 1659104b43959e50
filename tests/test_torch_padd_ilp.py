"""The padd_ilp kernel's plain version against padd's, against
zkvm_tpu.ops.g1_ops and against the grouped Pallas kernel it replaces; and
the halving-tree sum that compares the two additions.

Inputs are numpy-seeded multiples of the generator plus identity, doubling
and inverse lanes; coordinates are compared bit for bit after the layout
conversion (exact arithmetic, tolerance zero).
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.ops import g1_ops as rg1
from zkvm_tpu.ops import pallas_field
from zkvm_tpu_torch.curves.g1 import G1Affine, G1Projective
from zkvm_tpu_torch.ops import g1_ops, kernels
from zkvm_tpu_torch.ops import limb_field as lf

torch.set_num_threads(1)


def _points(n, seed):
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


@pytest.fixture(scope="module")
def pq():
    """34 lanes: random sums, then identity + P, P + identity, identity +
    identity, P + P and P + (-P)."""
    lhs = _points(34, 2)
    rhs = _points(34, 3)
    lhs[0] = G1Affine.identity()
    rhs[1] = G1Affine.identity()
    lhs[2] = rhs[2] = G1Affine.identity()
    rhs[3] = lhs[3]
    rhs[4] = -lhs[4]
    return lhs, rhs, _both(lhs), _both(rhs)


def test_padd_ilp_plain_equals_padd_plain(pq):
    _, _, (_, pp), (_, pq_) = pq
    got = kernels.padd_ilp_plain(pp, pq_)
    for g, w in zip(got, kernels.padd_plain(pp, pq_)):
        assert torch.equal(g, w)
    for g, w in zip(g1_ops.padd_ilp(pp, pq_), got):  # CPU: the plain version
        assert torch.equal(g, w)


def test_padd_ilp_matches_reference(pq):
    _, _, (rp, pp), (rq, pq_) = pq
    assert _same(g1_ops.padd_ilp(pp, pq_), rg1._padd_jnp(rp, rq))


def test_padd_ilp_matches_host_group_law(pq):
    lhs, rhs, (_, pp), (_, pq_) = pq
    got = kernels.padd_ilp(pp, pq_)
    for i in range(8):
        want = lhs[i].to_projective() + rhs[i].to_projective()
        assert g1_ops.device_to_projective(got, i) == want
    assert g1_ops.device_to_projective(got, 2).is_identity()
    assert g1_ops.device_to_projective(got, 4).is_identity()


def test_padd_ilp_plain_matches_pallas_interpret(pq):
    _, _, (rp, pp), (rq, pq_) = pq
    want = pallas_field.padd_pallas_ilp(rp, rq, block=128, interpret=True)
    assert _same(kernels.padd_ilp_plain(pp, pq_), want)


@pytest.mark.parametrize("add", ["padd", "padd_ilp"])
def test_sum_lanes_matches_host_sum(add):
    pts = _points(16, 7)
    pts[5] = G1Affine.identity()
    dev = g1_ops.affine_to_device(pts, "cpu")
    got = g1_ops.sum_lanes(dev, getattr(g1_ops, add))
    want = G1Projective.identity()
    for p in pts:
        want = want + p.to_projective()
    assert got[0].shape == (12, 1)
    assert g1_ops.device_to_projective(got) == want
    with pytest.raises(ValueError):
        g1_ops.sum_lanes(tuple(t[:, :12] for t in dev))


def test_padd_ilp_wrapper_checks_its_operands(pq):
    _, _, (_, pp), (_, pq_) = pq
    with pytest.raises(ValueError):
        kernels.padd_ilp(pp, tuple(t[:, :5].contiguous() for t in pq_))
    # every second lane is read in place; coordinates of one point with
    # different layouts are not
    got = kernels.padd_ilp(tuple(t[:, ::2] for t in pp),
                           tuple(t[:, ::2] for t in pq_))
    want = kernels.padd_plain(tuple(t[:, ::2].contiguous() for t in pp),
                              tuple(t[:, ::2].contiguous() for t in pq_))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    mixed = (pp[0], pp[1].T.contiguous().T, pp[2])
    with pytest.raises(ValueError, match="share one layout"):
        kernels.padd_ilp(mixed, pq_)
    with pytest.raises(ValueError):
        kernels.padd_ilp(tuple(t.to("meta") for t in pp),
                         tuple(t.to("meta") for t in pq_))
    empty = tuple(t[:, :0].contiguous() for t in pp)
    assert kernels.padd_ilp(empty, empty)[0].shape == (12, 0)
