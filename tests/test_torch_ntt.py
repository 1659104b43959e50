"""zkvm_tpu_torch.ops.ntt / ntt_mxu against zkvm_tpu.ops.ntt / ntt_mxu.

The same numpy-seeded Montgomery arrays go through both packages on the
CPU: the reference through its non-TPU branch (`_dft_leaf`'s carry scan,
`_ntt_impl_jnp`), the port through its kernels' plain versions.  `Domain`'s
transforms take the staged route (`ntt_stages`); the matmul route
(`ntt_mxu`), which no path calls, is held here as the cross-check.  Exact
integer arithmetic: tolerance zero, bit for bit after `to_reference`.
Sizes: 2^5 (a single leaf), 2^9 (two levels, uneven split 32 * 16) and
2^10 (even split 32 * 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_tpu import params
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import ntt as rntt
from zkvm_tpu.ops import ntt_mxu as rmxu
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import ntt, ntt_mxu
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk.errors import InvalidEvalDomainSize

torch.set_num_threads(1)

Q = params.FR_MODULUS
SIZES = [1 << 5, 1 << 9, 1 << 10]


def _values(count, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(count, 5), dtype=np.uint64)
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % Q
            for row in words.tolist()]


def _ref_array(lead, n, seed):
    """[16, *lead, n] uint32 Montgomery limbs, the reference's layout."""
    count = int(np.prod(lead, dtype=np.int64)) * n
    flat = lf.to_reference(FR.to_mont_array(_values(count, seed), "cpu"), FR)
    return flat.reshape((16,) + tuple(lead) + (n,))


def _same(port_tensor, ref_array) -> bool:
    return (lf.to_reference_lead(port_tensor, FR)
            == np.asarray(ref_array)).all()


@pytest.mark.parametrize("n", SIZES)
def test_plan_tables_match_reference(n):
    for root in (ntt.Domain(n).group_gen, ntt.Domain(n).group_gen_inv):
        assert root in (rntt.Domain(n).group_gen, rntt.Domain(n).group_gen_inv)
        port, ref = ntt_mxu.MXUTransform(n, root), rmxu.MXUTransform(n, root)
        stack = [(port.plan, ref.plan)]
        while stack:
            p, r = stack.pop()
            assert p.n == r.n and (p.a, p.b) == (r.a, r.b)
            if p.leaf_table is not None:
                assert (p.leaf_table.astype(np.int64)
                        == np.asarray(r.leaf_table).astype(np.int64)).all()
                lifted = p._lift("leaf_table", torch.device("cpu"))
                assert lifted.dtype == torch.float32
                assert p._lift("leaf_table", torch.device("cpu")) is lifted
            else:
                glue = lf.u32_to_tensor(p.glue.reshape(8, -1), "cpu")
                assert (lf.to_reference(glue, FR)
                        == np.asarray(r.glue).reshape(16, -1)).all()
                stack += [(p.sub_a, r.sub_a), (p.sub_b, r.sub_b)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("key", ["coset", "coset_inv_scaled", "size_inv"])
def test_domain_factors_match_reference(n, key):
    got = ntt.Domain(n)._factor(key, torch.device("cpu"))
    assert (lf.to_reference(got, FR)
            == np.asarray(rntt.Domain(n)._factor(key))).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)],
                         ids=["no_lead", "one_lead", "two_leads"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_mxu_transform_matches_reference(n, lead, inverse):
    dom = ntt.Domain(n)
    root = dom.group_gen_inv if inverse else dom.group_gen
    ref = _ref_array(lead, n, n + len(lead))
    want = rmxu.MXUTransform(n, root)(jnp.asarray(ref))
    got = ntt_mxu.MXUTransform(n, root)(lf.from_reference_lead(ref, FR, "cpu"))
    assert got.shape == tuple(lead) + (8, n)
    assert _same(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_per_byte_plane_branch_gives_the_same(n, monkeypatch):
    t = ntt_mxu.MXUTransform(n, ntt.Domain(n).group_gen)
    x = lf.from_reference_lead(_ref_array((2,), n, 11), FR, "cpu")
    want = t(x)
    monkeypatch.setattr(ntt_mxu, "C_WHOLE_MAX_BYTES", 0)
    assert torch.equal(t(x), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["fft_device", "ifft_device",
                                  "coset_fft_device", "coset_ifft_device"])
def test_domain_device_transforms_match_reference(n, name):
    """Batched over one and over two leading axes in the port; the
    reference's Domain transforms take one [16, n] polynomial at a time."""
    ref = _ref_array((2, 2), n, 21)
    rfn = getattr(rntt.Domain(n), name)
    want = np.stack([np.stack([np.asarray(rfn(jnp.asarray(ref[:, i, j])))
                               for j in range(2)], axis=1)
                     for i in range(2)], axis=1)  # [16, 2, 2, n]
    fn = getattr(ntt.Domain(n), name)
    x = lf.from_reference_lead(ref, FR, "cpu")
    assert _same(fn(x), want)
    assert _same(fn(x[0]), want[:, 0])
    assert _same(fn(x[1, 1]), want[:, 1, 1])


@pytest.mark.parametrize("n", [1, 2] + SIZES)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_butterfly_transform_matches_reference_and_matmul_route(n, inverse):
    ref = _ref_array((), n, 31)
    x = lf.from_reference_lead(ref, FR, "cpu")
    dom, rdom = ntt.Domain(n), rntt.Domain(n)
    got = ntt.butterfly_transform(dom, x, inverse)
    assert torch.equal(got, dom._run(x, inverse))  # Domain's own route
    if n > 1:
        root = dom.group_gen_inv if inverse else dom.group_gen
        assert torch.equal(got, ntt_mxu.MXUTransform(n, root)(x))
        brev, (even, odd, out, twi), fwd, inv = rdom._butterfly_tables()
        want = rntt._ntt_impl_jnp(jnp.asarray(ref), brev, even, odd, out, twi,
                                  inv if inverse else fwd)
        assert _same(got, want)
    batch = torch.stack([x, got])
    assert torch.equal(ntt.butterfly_transform(dom, batch, inverse)[0], got)


@pytest.mark.parametrize("n", SIZES)
def test_unfused_leaf_reduction_equals_fused(n):
    dom = ntt.Domain(n)
    x = lf.from_reference_lead(_ref_array((2,), n, 41), FR, "cpu")
    t = ntt_mxu.MXUTransform(n, dom.group_gen)
    assert torch.equal(ntt_mxu.transform_unfused(t, x), t(x))


def test_apply_axis_matches_reference():
    n = 32
    root = ntt.Domain(n).group_gen
    ref = _ref_array((n, 3), 5, 51)  # transform along the axis of length n
    want = rmxu.MXUTransform(n, root).apply_axis(jnp.asarray(ref), 1)
    x = lf.from_reference_lead(ref, FR, "cpu")  # [n, 3, 8, 5]
    t = ntt_mxu.MXUTransform(n, root)
    assert _same(t.apply_axis(x, 0), want)
    y = lf.from_reference_lead(_ref_array((2,), n, 52), FR, "cpu")
    assert torch.equal(t.apply_axis(y, -1), t(y))
    with pytest.raises(ValueError):
        t.apply_axis(x, -2)
    with pytest.raises(ValueError):
        t(x)  # last axis is not n


def test_round_trips_and_transform_singleton():
    n = 1 << 9
    dom = ntt.Domain(n)
    assert ntt.Domain(n) is dom
    assert (ntt_mxu.MXUTransform(n, dom.group_gen)
            is ntt_mxu.MXUTransform(n, dom.group_gen))
    x = lf.from_reference_lead(_ref_array((3,), n, 61), FR, "cpu")
    assert torch.equal(dom.ifft_device(dom.fft_device(x)), x)
    assert torch.equal(dom.coset_ifft_device(dom.coset_fft_device(x)), x)
    one = ntt.Domain(1)
    x1 = x[:, :, :1].contiguous()
    assert torch.equal(one.fft_device(x1), x1)


def test_host_conveniences_match_reference_and_horner():
    n = 32
    vals = _values(20, 71)  # shorter than the domain: zero-padded
    dom, rdom = ntt.Domain(n), rntt.Domain(n)
    for name in ("fft", "ifft", "coset_fft", "coset_ifft"):
        got = getattr(dom, name)([Fr(v) for v in vals], "cpu")
        want = getattr(rdom, name)([RFr(v) for v in vals])
        assert [g.value for g in got] == [w.value for w in want], name
    evals = dom.fft([Fr(v) for v in vals], "cpu")
    for k in (0, 1, 17, 31):
        w = pow(dom.group_gen, k, Q)
        assert evals[k].value == sum(c * pow(w, i, Q)
                                     for i, c in enumerate(vals)) % Q
    with pytest.raises(ValueError):
        dom.fft([Fr(1)] * (n + 1), "cpu")


def test_host_analytics_match_reference():
    n = 16
    dom, rdom = ntt.Domain(n), rntt.Domain(n)
    assert [e.value for e in dom.elements()] == \
        [e.value for e in rdom.elements()]
    tau = 0x1234567890ABCDEF
    assert dom.evaluate_vanishing_polynomial(Fr(tau)).value == \
        rdom.evaluate_vanishing_polynomial(RFr(tau)).value
    for t in (tau, dom.elements()[3].value):
        got = dom.evaluate_all_lagrange_coefficients(Fr(t))
        want = rdom.evaluate_all_lagrange_coefficients(RFr(t))
        assert [g.value for g in got] == [w.value for w in want]
    got = dom.compute_vanishing_poly_over_coset(4 * n)
    want = rdom.compute_vanishing_poly_over_coset(4 * n)
    assert [g.value for g in got] == [w.value for w in want]
    vals = [3, 0, 5]
    assert ntt._batch_inverse(vals, Q) == rntt._batch_inverse(vals, Q)
    assert (ntt.bit_reverse_indices(64) == rntt.bit_reverse_indices(64)).all()


def test_invalid_domain_sizes():
    with pytest.raises(ValueError):
        ntt.Domain(12)
    with pytest.raises(ValueError):
        ntt.Domain(0)
    with pytest.raises(InvalidEvalDomainSize):
        ntt.Domain(1 << (params.FR_TWO_ADICITY + 1))
