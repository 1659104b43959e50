"""zkvm_tpu_torch.ops.limb_field against zkvm_tpu.ops.limb_field.

The same numpy-seeded field elements go through the JAX reference (16-bit
limbs, [16|24, B] uint32) and the port (32-bit limbs, [8|12, B] int32) by
way of the one converter pair; outputs must be bit-identical (exact
integer arithmetic, tolerance zero).  Batches include the edge values 0, 1
and p - 1 and cross the 256-lane block of the Pallas kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import zkvm_tpu.ops.limb_field as rlf
from zkvm_tpu import params
from zkvm_tpu.ops import pallas_field
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf

torch.set_num_threads(1)

SPECS = {"Fr": (rlf.FR, lf.FR), "Fq": (rlf.FQ, lf.FQ)}


def _values(spec, n, seed):
    """n field elements from a numpy seed, edge values first."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 7), dtype=np.uint64).tolist()
    vals = [sum(int(w) << (63 * k) for k, w in enumerate(row)) % spec.modulus
            for row in words]
    vals[:3] = [0, 1, spec.modulus - 1]
    return vals


def _pair(name, n, seed):
    """(reference array, port tensor) of the same Montgomery elements."""
    rspec, pspec = SPECS[name]
    ref = np.array(rspec.to_mont_array(_values(pspec, n, seed)))
    return ref, lf.from_reference(ref, pspec, "cpu")


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_converters_round_trip(name):
    rspec, pspec = SPECS[name]
    ref, port = _pair(name, 37, 1)
    assert port.dtype == torch.int32 and port.shape == (pspec.n_limbs, 37)
    assert (lf.to_reference(port, pspec) == ref).all()
    # the values agree limb for limb as integers
    for j in (0, 1, 2, 36):
        assert (rlf.limbs_to_int(ref[:, j])
                == lf.limbs_to_int(lf.tensor_to_u32(port)[:, j]))
    vals = _values(pspec, 20, 2)
    assert pspec.from_mont_array(pspec.to_mont_array(vals, "cpu")) == vals


BINARY = {"mont_mul": (rlf.mont_mul, lf.mont_mul),
          "add": (rlf.add, lf.add),
          "sub": (rlf.sub, lf.sub)}
UNARY = {"neg": (rlf.neg, lf.neg),
         "to_mont": (rlf.to_mont, lf.to_mont),
         "from_mont": (rlf.from_mont, lf.from_mont)}


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_reference(name, op):
    rspec, pspec = SPECS[name]
    ra, pa = _pair(name, 300, 3)
    rb, pb = _pair(name, 300, 4)
    rb[:, 5], pb[:, 5] = ra[:, 5], pa[:, 5]  # equal operands
    ref_fn, port_fn = BINARY[op]
    want = np.asarray(ref_fn(rspec, ra, rb))
    assert (lf.to_reference(port_fn(pspec, pa, pb), pspec) == want).all()


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_reference(name, op):
    rspec, pspec = SPECS[name]
    ra, pa = _pair(name, 300, 5)
    ref_fn, port_fn = UNARY[op]
    want = np.asarray(ref_fn(rspec, ra))
    assert (lf.to_reference(port_fn(pspec, pa), pspec) == want).all()


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_mont_inv_and_pow_match_reference(name):
    rspec, pspec = SPECS[name]
    ra, pa = _pair(name, 8, 6)  # lane 0 is zero: inverts to zero
    want = np.asarray(rlf.mont_inv(rspec, ra))
    assert (lf.to_reference(lf.mont_inv(pspec, pa), pspec) == want).all()
    want = np.asarray(rlf.mont_pow(rspec, ra, 77))
    assert (lf.to_reference(lf.mont_pow(pspec, pa, 77), pspec) == want).all()


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_mont_mul_plain_matches_pallas_interpret(name):
    """The mont_mul kernel's plain version against the TPU kernel it
    replaces, in interpret mode, on a batch crossing the block edge."""
    rspec, pspec = SPECS[name]
    ra, pa = _pair(name, 513, 7)
    rb, pb = _pair(name, 513, 8)
    want = np.asarray(pallas_field.mont_mul_pallas(rspec, ra, rb, block=256,
                                                   interpret=True))
    got = kernels.mont_mul_plain(pspec, pa, pb)
    assert (lf.to_reference(got, pspec) == want).all()


@pytest.mark.parametrize("size", [1, 5000])
def test_carry_chains_both_strategies(size):
    """Long carry/borrow chains (all-ones limbs) through the small-batch
    lookahead and the large-batch ripple give the host's answers."""
    spec = lf.FQ
    q = spec.modulus
    vals_a = [q - 1, (1 << 380) - 1, 1 << 352, q - (1 << 200)]
    vals_b = [q - 1, 1, (1 << 352) - 1, (1 << 200) + 1]
    reps = -(-size // 4)
    a = spec.to_raw_array((vals_a * reps)[:size], "cpu")
    b = spec.to_raw_array((vals_b * reps)[:size], "cpu")
    rinv = pow(spec.R, -1, q)
    pairs = list(zip(vals_a * reps, vals_b * reps))[:size]
    assert lf.raw_to_ints(spec, lf.add(spec, a, b)) == [
        (x + y) % q for x, y in pairs]
    assert lf.raw_to_ints(spec, lf.sub(spec, b, a)) == [
        (y - x) % q for x, y in pairs]
    assert lf.raw_to_ints(spec, lf.mont_mul(spec, a, b)) == [
        x * y * rinv % q for x, y in pairs]


def _cuh_array(text, struct, fn):
    body = re.search(rf"struct {struct} {{(.*?)\n}};", text, re.S).group(1)
    arr = re.search(rf"{fn}\(int i\) {{\s*constexpr uint32_t v\[N\] = "
                    r"\{(.*?)\};", body, re.S).group(1)
    return [int(x, 16) for x in arr.replace("\n", " ").split(",")]


def test_cuda_constants_match_params():
    """The limb constants compiled into csrc/field.cuh are the fields'."""
    text = Path(kernels.CSRC, "field.cuh").read_text()
    for struct, spec in (("Fr", lf.FR), ("Fq", lf.FQ)):
        assert _cuh_array(text, struct, "p") == list(spec.p_limbs)
        np0 = re.search(rf"struct {struct} {{.*?NP0 = (0x[0-9a-f]+)u",
                        text, re.S).group(1)
        assert int(np0, 16) == spec.nprime
    assert _cuh_array(text, "Fq", "one") == list(lf.FQ.one_mont)
    assert _cuh_array(text, "Fq", "b3") == list(
        lf.FQ.mont_limbs(3 * params.G1_B))
