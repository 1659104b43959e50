"""The grand product of the port against zkvm_tpu's, bit for bit.

`Permutation.compute_permutation_tensor` takes the same numpy-seeded wire,
sigma and root tensors and the same challenges as the reference's at
n = 2^5 and 2^9; its two `jax.lax.associative_scan`s are the port's
log-depth `dpoly.prefix_products`, forward and reverse, which the test also
holds against a serial product (the product mod r is exact, so the grouping
shows in no bit).  The copied host half (cycles, sigma polynomials, the
small-domain host grand product) is held against the reference too.
"""

import numpy as np
import pytest
import torch

import zkvm_tpu.ops.limb_field as rlf
import zkvm_tpu.ops.ntt as rntt
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.plonk.permutation import Permutation as RPermutation
from zkvm_tpu.plonk.polynomial import Polynomial as RPolynomial
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.ntt import Domain
from zkvm_tpu_torch.plonk import dpoly
from zkvm_tpu_torch.plonk.permutation import Permutation
from zkvm_tpu_torch.plonk.polynomial import Polynomial

torch.set_num_threads(1)

P = lf.FR.modulus


def _ints(n, rng):
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % P
            for row in words]


@pytest.mark.parametrize("log_n", [5, 9])
def test_compute_permutation_tensor_matches_reference(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    wires = [_ints(n, rng) for _ in range(4)]
    sigmas = [_ints(n, rng) for _ in range(4)]
    beta, gamma = _ints(2, rng)
    roots = rntt.Domain(n)._powers(rntt.Domain(n).group_gen)
    want = RPermutation.compute_permutation_tensor(
        rntt.Domain(n), [rlf.FR.to_mont_array(w) for w in wires],
        [rlf.FR.to_mont_array(s) for s in sigmas],
        rlf.FR.to_mont_array(roots), RFr(beta), RFr(gamma))
    got = Permutation.compute_permutation_tensor(
        Domain(n), [lf.FR.to_mont_array(w, "cpu") for w in wires],
        [lf.FR.to_mont_array(s, "cpu") for s in sigmas],
        lf.FR.to_mont_array(roots, "cpu"), Fr(beta), Fr(gamma))
    assert got.shape == (8, n)
    assert (lf.to_reference(got, lf.FR) == np.asarray(want)).all()
    z = lf.FR.from_mont_array(got)
    assert z[0] == 1


@pytest.mark.parametrize("m", [1, 2, 3, 7, 64, 129])
@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_products_match_a_serial_product(m, reverse):
    vals = _ints(m, np.random.default_rng(m))
    vals[0] = 0 if m > 2 else vals[0]
    got = lf.FR.from_mont_array(dpoly.prefix_products(
        lf.FR.to_mont_array(vals, "cpu"), reverse=reverse))
    seq = vals[::-1] if reverse else vals
    acc, want = 1, []
    for v in seq:
        acc = acc * v % P
        want.append(acc)
    assert got == (want[::-1] if reverse else want)


def _random_permutation(cls, n, rng):
    perm = cls()
    ws = [perm.new_witness() for _ in range(n // 2)]
    for gate in range(n):
        picks = rng.integers(0, len(ws), size=4)
        perm.add_witnesses_to_map(*(ws[int(i)] for i in picks), gate)
    return perm


def test_host_half_matches_reference():
    n = 16
    perm = _random_permutation(Permutation, n, np.random.default_rng(1))
    rperm = _random_permutation(RPermutation, n, np.random.default_rng(1))
    got = perm.compute_sigma_permutations(n)
    want = rperm.compute_sigma_permutations(n)
    assert [[(w.kind, w.gate) for w in s] for s in got] == \
        [[(w.kind, w.gate) for w in s] for s in want]
    polys = perm.compute_sigma_polynomials(n, Domain(n), "cpu")
    rpolys = rperm.compute_sigma_polynomials(n, rntt.Domain(n))
    assert [[c.value for c in p.coeffs] for p in polys] == \
        [[c.value for c in p.coeffs] for p in rpolys]
    rng = np.random.default_rng(2)
    wires = [_ints(n, rng) for _ in range(4)]
    beta, gamma = _ints(2, rng)
    got = perm.compute_permutation_vec(
        Domain(n), [[Fr(v) for v in w] for w in wires], Fr(beta), Fr(gamma),
        [Polynomial([Fr(c.value) for c in p.coeffs]) for p in rpolys], "cpu")
    want = rperm.compute_permutation_vec(
        rntt.Domain(n), [[RFr(v) for v in w] for w in wires], RFr(beta),
        RFr(gamma), [RPolynomial(p.coeffs) for p in rpolys])
    assert [v.value for v in got] == [v.value for v in want]
