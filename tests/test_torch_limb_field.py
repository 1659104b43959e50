"""zkvm_tpu_torch.ops.limb_field against zkvm_tpu.ops.limb_field.

The same numpy-seeded field elements go through the JAX reference (16-bit
limbs, [16|24, B] uint32) and the port (32-bit limbs, [8|12, B] int32) by
way of the one converter pair; outputs must be bit-identical (exact
integer arithmetic, tolerance zero).  Batches include the edge values 0, 1
and p - 1 and cross the 256-lane block of the Pallas kernel.  The multiply
is also driven with broadcast and strided operands (a constant column, a
table shared by every group, an [L, 1] lane broadcast, every second lane)
against the reference on the materialised operands, and the callers that
used to build a full tensor for a broadcast operand are watched handing
over the small one.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import zkvm_tpu.ops.limb_field as rlf
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
@pytest.mark.parametrize("e", [0, 1, 2, 5, 0b110100111])
def test_mont_pow_small_exponents_match_reference(name, e):
    rspec, pspec = SPECS[name]
    ra, pa = _pair(name, 9, 9)  # lane 0 is zero
    want = np.asarray(rlf.mont_pow(rspec, ra, e))
    assert (lf.to_reference(lf.mont_pow(pspec, pa, e), pspec) == want).all()
    assert torch.equal(kernels.mont_pow_plain(pspec, pa, e),
                       lf.mont_pow(pspec, pa, e))


def test_mont_pow_wrapper_checks_its_operands():
    a = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="exponent"):
        kernels.mont_pow(lf.FR, a, -1)
    with pytest.raises(ValueError, match="exponent"):
        kernels.mont_pow(lf.FR, a, 1 << 384)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.mont_pow(lf.FR, torch.zeros((8, 8), dtype=torch.int32)[:, ::2],
                         3)
    with pytest.raises(ValueError, match="limb axis"):
        kernels.mont_pow(lf.FQ, a, 3)
    with pytest.raises(TypeError):
        kernels.mont_pow(lf.FR, a.to(torch.int64), 3)
    assert kernels.mont_pow(lf.FR, a[:, :0].contiguous(), 3).shape == (8, 0)


def _watch_mont_mul(monkeypatch):
    seen = []
    real = kernels.mont_mul
    monkeypatch.setattr(kernels, "mont_mul", lambda sp, x, y: (
        seen.append((x, y)), real(sp, x, y))[1])
    return seen


# how the second operand of a [3, L, 10] batch is handed over, and the same
# operand materialised for the reference
OPERANDS = {
    "constant_column": lambda b: (b[0, :, :1], b[0, :, :1].expand(3, -1, 10)),
    "shared_table": lambda b: (b[1], b[1].expand(3, -1, -1)),
    "lane_broadcast": lambda b: (b[:, :, 4:5],
                                 b[:, :, 4:5].expand(-1, -1, 10)),
    "expanded_view": lambda b: (b[2].expand(3, -1, -1),
                                b[2].expand(3, -1, -1)),
    "every_second_lane": lambda b: (b[:, :, 0::2], b[:, :, 0::2]),
}


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("kind", sorted(OPERANDS))
@pytest.mark.parametrize("side", ["second", "first"])
def test_mont_mul_broadcast_and_strided_operands(name, kind, side,
                                                 monkeypatch):
    """`lf.mont_mul` hands the operand over as it is (no copy, no tensor of
    the full shape) and equals the reference on the materialised operands."""
    rspec, pspec = SPECS[name]
    lanes = 20 if kind == "every_second_lane" else 10
    _, pa = _pair(name, 3 * 10, 10)
    _, pb = _pair(name, 3 * lanes, 11)
    a = pa.reshape(-1, 3, 10).permute(1, 0, 2).contiguous()      # [3, L, 10]
    b = pb.reshape(-1, 3, lanes).permute(1, 0, 2).contiguous()
    given, full = OPERANDS[kind](b)
    seen = _watch_mont_mul(monkeypatch)
    got = (lf.mont_mul(pspec, a, given) if side == "second"
           else lf.mont_mul(pspec, given, a))
    (x, y), = seen
    handed = y if side == "second" else x
    assert handed.data_ptr() == given.data_ptr()
    assert handed.stride() == given.stride() and handed.shape == given.shape
    assert kernels.mont_mul_layout(handed, a.shape) is not None
    want = np.asarray(rlf.mont_mul(
        rspec, lf.to_reference(a, pspec),
        lf.to_reference(full.contiguous(), pspec)))
    assert got.is_contiguous() and got.shape == a.shape
    assert (lf.to_reference(got, pspec) == want).all()
    assert torch.equal(got, kernels.mont_mul_plain(pspec, a, given))


def test_mont_mul_layouts():
    full = torch.zeros((4, 3, 8, 10), dtype=torch.int32)
    shape = full.shape
    layout = kernels.mont_mul_layout
    assert layout(full, shape) == (80, 10, 1)
    assert layout(full[0, 0], shape) == (0, 10, 1)           # shared table
    assert layout(full[0, 0, :, :1], shape) == (0, 10, 0)    # constant column
    assert layout(full[..., 3:4], shape) == (80, 10, 0)      # lane broadcast
    assert layout(full[..., ::2], (4, 3, 8, 5)) == (80, 10, 2)
    assert layout(full.transpose(2, 3).contiguous().transpose(2, 3),
                  shape) == (80, 1, 8)                       # limbs innermost
    # broadcast over the middle axis only: the leading axes do not collapse
    assert layout(full[:, :1], shape) is None
    assert layout(full[:, :2], shape) is None            # does not broadcast
    assert layout(full[..., :1, :], shape) is None           # limb axis of one
    assert layout(torch.zeros((8,), dtype=torch.int32), shape) is None
    assert layout(full, shape[1:]) is None                   # too many axes


def test_mont_mul_wrapper_raises_on_what_it_cannot_read():
    a = torch.zeros((4, 3, 8, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot be read in place"):
        kernels.mont_mul(lf.FR, a, a[:, :1])
    with pytest.raises(ValueError, match="do not broadcast"):
        kernels.mont_mul(lf.FR, a, a[..., :7])
    with pytest.raises(ValueError, match="limb axis"):
        kernels.mont_mul(lf.FR, a, a[..., :1, :])
    with pytest.raises(ValueError, match="limb axis"):
        kernels.mont_mul(lf.FQ, a, a)
    with pytest.raises(TypeError):
        kernels.mont_mul(lf.FR, a, a.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.mont_mul(lf.FR, a, a.to("meta"))
    # what the kernel cannot read, `lf.mont_mul` copies first
    got = lf.mont_mul(lf.FR, a, a[:, :1])
    assert got.shape == a.shape and not got.any()


def _storage_words(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes() // 4


@pytest.mark.parametrize("caller", ["mont_mul_const", "powers_device",
                                    "eval_stack", "ntt_scale", "mxu_glue"])
def test_no_tensor_of_the_full_shape_is_made_for_a_broadcast_operand(
        caller, monkeypatch):
    from zkvm_tpu_torch.fields import Fr
    from zkvm_tpu_torch.ops import ntt, ntt_mxu
    from zkvm_tpu_torch.plonk import dpoly

    seen = _watch_mont_mul(monkeypatch)
    _, pa = _pair("Fr", 4 * 16, 12)
    stack = pa.reshape(8, 4, 16).permute(1, 0, 2).contiguous()   # [4, 8, 16]
    if caller == "mont_mul_const":
        lf.mont_mul_const(lf.FR, stack, lf.FR.mont_limbs(12345))
        (_, b), = seen
        assert b.shape == (8, 1)
    elif caller == "powers_device":
        got = dpoly.powers_device(dpoly.const_col(7, "cpu"), 16)
        assert lf.FR.from_mont_array(got) == [pow(7, i, lf.FR.modulus)
                                              for i in range(16)]
        wide = [b for _, b in seen if b.shape[-1] > 1]
        assert len(wide) == 3                       # steps at 2, 4, 8 lanes
        assert all(b.stride(-1) == 0 and _storage_words(b) == 8 for b in wide)
    elif caller == "eval_stack":
        z = Fr(0x1234567 << 90 | 5)
        got = dpoly.eval_stack(stack, z)
        coeffs = [lf.FR.from_mont_array(stack[k]) for k in range(4)]
        assert [g.value for g in got] == [
            sum(c * pow(z.value, i, lf.FR.modulus) for i, c in enumerate(cs))
            % lf.FR.modulus for cs in coeffs]
        (a, b), = [pair for pair in seen if pair[0].shape == stack.shape]
        assert b.shape == stack.shape
        assert b.stride(0) == 0 and _storage_words(b) == 8 * 16
    elif caller == "ntt_scale":
        factors = stack[0]
        ntt._scale(stack, factors)
        (_, b), = seen
        assert b.data_ptr() == factors.data_ptr() and b.stride(0) == 0
    else:
        glue = stack[1]
        ntt_mxu._mont_mul_lead(stack, glue)
        (_, b), = seen
        assert b.data_ptr() == glue.data_ptr() and b.stride(0) == 0
    for a, b in seen:   # nothing handed over was a copy of a broadcast
        for t in (a, b):
            assert _storage_words(t) <= max(t.numel(), 8 * 16 * 4)
            assert not (t.is_contiguous() and t.numel() > _storage_words(t))


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
    # the split-fold constants (3b went with the last fully reduced G1
    # addition; the lazy kernels take 12 t as four additions)
    assert _cuh_array(text, "Fr", "k1") == list(kernels.K1)
    assert _cuh_array(text, "Fr", "k2") == list(kernels.K2)
