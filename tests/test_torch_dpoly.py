"""zkvm_tpu_torch.plonk.dpoly (and the host Polynomial copy) against
zkvm_tpu.plonk.dpoly / polynomial.

The same numpy-seeded values go through both packages on the CPU; results
must match bit for bit after `to_reference` (exact arithmetic, tolerance
zero).  Each package draws blinders from its own StdRng with one seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.plonk import dpoly as rdpoly
from zkvm_tpu.plonk.polynomial import Polynomial as RPolynomial
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk import dpoly
from zkvm_tpu_torch.plonk.polynomial import Polynomial
from zkvm_tpu_torch.rng import StdRng

torch.set_num_threads(1)

Q = Fr.MODULUS


def _values(count, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(count, 5), dtype=np.uint64)
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % Q
            for row in words.tolist()]


def _both(vals, size=None):
    """The same polynomial as a port tensor [8, size] and a reference
    array [16, size]."""
    size = len(vals) if size is None else size
    return dpoly.to_device(vals, size, "cpu"), rdpoly.to_device(vals, size)


def _same(port_tensor, ref_array) -> bool:
    return (lf.to_reference(port_tensor, FR) == np.asarray(ref_array)).all()


def test_to_device_from_device_const_col():
    vals = _values(11, 1)
    port, ref = _both(vals, 16)
    assert port.shape == (8, 16) and port.dtype == torch.int32
    assert _same(port, ref)
    assert _same(dpoly.to_device([Fr(v) for v in vals], 16, "cpu"), ref)
    assert [f.value for f in dpoly.from_device(port)] == vals + [0] * 5
    assert _same(dpoly.const_col(vals[0], "cpu"), rdpoly.const_col(vals[0]))
    assert _same(dpoly.const_col(Q + 3, "cpu"), rdpoly.const_col(Q + 3))


@pytest.mark.parametrize("m", [1, 2, 5, 64, 100])
def test_powers_device_matches_reference(m):
    z = _values(1, 2)[0]
    got = dpoly.powers_device(dpoly.const_col(z, "cpu"), m)
    assert got.shape == (8, m)
    assert _same(got, rdpoly.powers_device(rdpoly.const_col(z), m))
    assert dpoly.from_device(got)[-1].value == pow(z, m - 1, Q)


@pytest.mark.parametrize("m", [1, 7, 64, 70])
def test_eval_stack_matches_reference_and_horner(m):
    z = _values(1, 3)[0]
    polys = [_values(m, 10 + k) for k in range(3)]
    pairs = [_both(p) for p in polys]
    got = dpoly.eval_stack(torch.stack([p for p, _ in pairs]), Fr(z))
    want = rdpoly.eval_stack(jnp.stack([r for _, r in pairs]), RFr(z))
    assert [g.value for g in got] == [w.value for w in want]
    for g, p in zip(got, polys):
        assert g.value == Polynomial([Fr(c) for c in p]).evaluate(Fr(z)).value


@pytest.mark.parametrize("m", [2, 3, 8, 33, 70])
def test_ruffini_device_matches_reference_and_host(m):
    z = _values(1, 4)[0]
    vals = _values(m, 20 + m)
    port, ref = _both(vals)
    got = dpoly.ruffini_device(port, Fr(z))
    assert got.shape == (8, m - 1)
    assert _same(got, rdpoly.ruffini_device(ref, RFr(z)))
    host = Polynomial([Fr(c) for c in vals]).ruffini(Fr(z))
    rhost = RPolynomial([RFr(c) for c in vals]).ruffini(RFr(z))
    assert [c.value for c in host.coeffs] == [c.value for c in rhost.coeffs]
    quotient = [f.value for f in dpoly.from_device(got)]
    assert quotient[:len(host.coeffs)] == [c.value for c in host.coeffs]
    assert not any(quotient[len(host.coeffs):])


def test_ruffini_device_at_zero():
    vals = _values(9, 5)
    port, ref = _both(vals)
    got = dpoly.ruffini_device(port, Fr.zero())
    assert _same(got, rdpoly.ruffini_device(ref, RFr.zero()))
    assert [f.value for f in dpoly.from_device(got)] == vals[1:]


@pytest.mark.parametrize("m", [1, 2, 5, 16, 37])
def test_suffix_sums(m):
    vals = _values(m, 6)
    got = dpoly.from_device(dpoly._suffix_sums(dpoly.to_device(vals, m,
                                                               "cpu")))
    assert [g.value for g in got] == [sum(vals[i:]) % Q for i in range(m)]


def test_lin_comb_matches_reference():
    a, b, c = _values(10, 7), _values(6, 8), _values(10, 9)
    k = _values(1, 10)[0]
    pa, ra = _both(a)
    pb, rb = _both(b)
    pc, rc = _both(c)
    got = dpoly.lin_comb([(pa, Fr(k)), (pb, Fr.one()), (pc, Fr.zero()),
                          (pc, 3)], 12, "cpu")
    want = rdpoly.lin_comb([(ra, RFr(k)), (rb, RFr.one()), (rc, RFr.zero()),
                            (rc, 3)], 12)
    assert got.shape == (8, 12)
    assert _same(got, want)
    vals = [f.value for f in dpoly.from_device(got)]
    for i in range(12):
        ai = a[i] if i < 10 else 0
        bi = b[i] if i < 6 else 0
        ci = c[i] if i < 10 else 0
        assert vals[i] == (k * ai + bi + 3 * ci) % Q
    empty = dpoly.lin_comb([(pa, Fr.zero())], 12, "cpu")
    assert _same(empty, rdpoly.lin_comb([(ra, RFr.zero())], 12))


@pytest.mark.parametrize("hiding_degree", [1, 2])
def test_apply_blinders_device_draws_in_the_reference_order(hiding_degree):
    vals = _values(16, 11)
    port, ref = _both(vals)
    rng, rrng = StdRng(99), RStdRng(99)
    got = dpoly.apply_blinders_device(rng, port, hiding_degree)
    want = rdpoly.apply_blinders_device(rrng, ref, hiding_degree)
    assert got.shape == (8, 16 + hiding_degree + 1)
    assert _same(got, want)
    # both generators are left in the same state
    assert Fr.random(rng).value == RFr.random(rrng).value


def test_polynomial_copy_matches_reference():
    a, b = _values(9, 12), _values(5, 13)
    pa, pb = Polynomial([Fr(v) for v in a]), Polynomial([Fr(v) for v in b])
    ra, rb = RPolynomial([RFr(v) for v in a]), RPolynomial([RFr(v) for v in b])
    z = _values(1, 14)[0]
    for got, want in (((pa + pb), (ra + rb)), ((pa - pb), (ra - rb)),
                      ((pa * pb), (ra * rb)), (pa.scale(Fr(z)),
                                               ra.scale(RFr(z)))):
        assert [c.value for c in got.coeffs] == [c.value for c in want.coeffs]
    assert pa.degree() == ra.degree() == 8
    assert pa.evaluate(Fr(z)).value == ra.evaluate(RFr(z)).value
    assert Polynomial.zero().degree() == RPolynomial.zero().degree()
