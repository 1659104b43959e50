"""The field add / sub / neg of the port against zkvm_tpu's, and what the
`field_addsub` kernel computes, checked on the CPU.

`lf.add` / `lf.sub` / `lf.neg` go through `kernels.field_addsub` (its plain
version on a CPU tensor) and must equal the reference's `add` / `sub` /
`neg` bit for bit at the edge values 0, 1, p - 1 and R mod p, on contiguous,
broadcast and strided operands, with and without a lane mask.  The callers
hand the kernel every operand and the mask as they are (no copy).

The kernel cannot run here, so its arithmetic is modelled: the carry chains
are NOT rewritten in Python but read out of `csrc/field_addsub.cu` and
executed on 32-bit words with an explicit carry flag (`tests/ptx_model.py`),
and the C++ around them (`field_op`) is transcribed; a pin test holds the
transcription to the source.  The gate for the kernel itself is the
bit-for-bit comparison on the card (`tests/test_torch_kernels_gpu.py`,
`chip_smoke.py`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import zkvm_tpu.ops.limb_field as rlf
from ptx_model import check_operands_all_used, function_body, parse_chains
from ptx_model import run_chain as ptx_run_chain
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf

torch.set_num_threads(1)

SPECS = {"Fr": (rlf.FR, lf.FR), "Fq": (rlf.FQ, lf.FQ)}
SOURCE = (Path(kernels.CSRC) / "field_addsub.cu").read_text()
CHAINS = parse_chains(SOURCE)
M32 = 0xFFFFFFFF


def _values(spec, n, seed):
    """n field elements from a numpy seed, edge values first."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 7), dtype=np.uint64).tolist()
    vals = [sum(int(w) << (63 * k) for k, w in enumerate(row)) % spec.modulus
            for row in words]
    vals[:4] = [0, 1, spec.modulus - 1, spec.R]
    return vals


def _pair(name, n, seed):
    """(reference array, port tensor) of the same Montgomery elements."""
    rspec, pspec = SPECS[name]
    ref = np.array(rspec.to_mont_array(_values(pspec, n, seed)))
    return ref, lf.from_reference(ref, pspec, "cpu")


def _batch(name, lanes, seed):
    """[3, L, lanes] port tensor; every edge value meets every other."""
    _, pspec = SPECS[name]
    _, t = _pair(name, 3 * lanes, seed)
    return t.reshape(pspec.n_limbs, 3, lanes).permute(1, 0, 2).contiguous()


def _ref(name, op, a, b=None):
    rspec, pspec = SPECS[name]
    ra = lf.to_reference(a.contiguous(), pspec)
    if op == "neg":
        return np.asarray(rlf.neg(rspec, ra))
    rb = lf.to_reference(b.contiguous(), pspec)
    return np.asarray(getattr(rlf, op)(rspec, ra, rb))


def _watch(monkeypatch):
    seen = []
    real = kernels.field_addsub
    monkeypatch.setattr(kernels, "field_addsub", lambda sp, op, a, b=None,
                        mask=None: (seen.append((a, b, mask)),
                                    real(sp, op, a, b, mask))[1])
    return seen


# how the second operand of a [3, L, 12] batch is handed over
OPERANDS = {
    "contiguous": lambda b: b[:, :, :12].contiguous(),
    "constant_column": lambda b: b[0, :, :1],
    "shared_table": lambda b: b[1, :, :12],
    "lane_broadcast": lambda b: b[:, :, 4:5],
    "every_second_lane": lambda b: b[:, :, 0::2],
    "limbs_innermost": lambda b: b[:, :, :12].transpose(1, 2).contiguous()
    .transpose(1, 2),
}


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("kind", sorted(OPERANDS))
def test_binary_ops_on_broadcast_and_strided_operands(name, op, kind,
                                                      monkeypatch):
    _, pspec = SPECS[name]
    a = _batch(name, 12, 1)
    given = OPERANDS[kind](_batch(name, 24, 2))
    seen = _watch(monkeypatch)
    for x, y in ((a, given), (given, a)):
        got = getattr(lf, op)(pspec, x, y)
        assert got.is_contiguous() and got.shape == a.shape
        want = _ref(name, op, x.expand(a.shape), y.expand(a.shape))
        assert (lf.to_reference(got, pspec) == want).all()
    for (x, y, mask), (u, v) in zip(seen, ((a, given), (given, a))):
        assert mask is None
        assert x.data_ptr() == u.data_ptr() and x.stride() == u.stride()
        assert y.data_ptr() == v.data_ptr() and y.stride() == v.stride()


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("kind", ["contiguous", "every_second_lane",
                                  "limbs_innermost"])
def test_neg_matches_reference(name, kind):
    _, pspec = SPECS[name]
    a = OPERANDS[kind](_batch(name, 24, 3))
    got = lf.neg(pspec, a)
    assert (lf.to_reference(got, pspec) == _ref(name, "neg", a)).all()
    if kind == "contiguous":
        assert not got[0, :, 0].any()      # lane 0 of group 0 holds 0: -0 = 0


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_masked_ops_select_per_lane(name, op, monkeypatch):
    """With a [..., B] mask: the operation where it is set, a where it is
    clear -- the mask read in place, broadcast over the limbs (and over the
    groups when it is one row).  `lf.neg` takes the mask (`ops/msm.py`
    negates with it); add and sub take it at the kernel's wrapper."""
    _, pspec = SPECS[name]
    a = _batch(name, 12, 4)
    b = _batch(name, 12, 5)
    rng = np.random.default_rng(6)
    for mask in (torch.from_numpy(rng.integers(0, 2, (3, 12)) == 1),
                 torch.from_numpy(rng.integers(0, 2, (12,)) == 1),
                 torch.from_numpy(rng.integers(0, 2, (3, 24)) == 1)[:, ::2]):
        seen = _watch(monkeypatch)
        args = (a,) if op == "neg" else (a, b)
        got = (lf.neg(pspec, a, mask=mask) if op == "neg" else
               kernels.field_addsub(pspec, op, a, b, mask))
        full = _ref(name, op, *args)
        keep = lf.to_reference(a, pspec)
        sel = mask.expand(3, 12).numpy()[:, None, :]
        assert (lf.to_reference(got, pspec) == np.where(sel, full, keep)).all()
        (_, _, handed), = seen
        assert handed.data_ptr() == mask.data_ptr()
        assert handed.stride() == mask.stride()


def test_msm_select_of_a_negation_is_one_masked_pass(monkeypatch):
    """The MSM's gather on the CPU (`kernels.msm_gather_plain`, reached
    through `ops/msm.py`) negates the y of the points whose digit is
    negative in one masked pass over the strided gather (no select after
    it)."""
    from zkvm_tpu_torch.ops import msm

    seen = _watch(monkeypatch)
    calls = []
    real_select = lf.select
    monkeypatch.setattr(lf, "select", lambda *a: (calls.append(a),
                                                  real_select(*a))[1])
    pts = tuple(torch.zeros((12, 8), dtype=torch.int32) for _ in range(3))
    pm = torch.cat(pts, dim=0).T.contiguous()
    pinf = torch.ones(8, dtype=torch.bool)
    limbs = torch.arange(2 * 8 * 8, dtype=torch.int32).reshape(2, 8, 8)
    msm._sorted_points(3, pm, pinf, limbs)
    (_, b, mask), = seen
    assert b is None and mask is not None and mask.dtype == torch.bool
    assert not calls


def test_field_addsub_wrapper_checks_its_operands():
    a = torch.zeros((4, 3, 8, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot be read in place"):
        kernels.field_addsub(lf.FR, "add", a, a[:, :1])
    with pytest.raises(ValueError, match="op"):
        kernels.field_addsub(lf.FR, "neg", a, a)
    with pytest.raises(ValueError, match="op"):
        kernels.field_addsub(lf.FR, "mul", a, a)
    with pytest.raises(ValueError, match="limb axis"):
        kernels.field_addsub(lf.FQ, "add", a, a)
    with pytest.raises(TypeError):
        kernels.field_addsub(lf.FR, "sub", a, a.to(torch.int64))
    with pytest.raises(ValueError, match="mask"):
        kernels.field_addsub(lf.FR, "neg", a, None,
                             torch.zeros((4, 3, 10), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.field_addsub(lf.FR, "add", a, a.to("meta"))
    # what the kernel cannot read, `lf.add` copies first
    assert lf.add(lf.FR, a, a[:, :1]).shape == a.shape
    mask = torch.zeros((4, 2, 10), dtype=torch.bool)[:, :1]   # [4, 1, 10]
    assert kernels.mask_layout(mask, a.shape) is None
    assert lf.neg(lf.FR, a, mask).shape == a.shape
    assert kernels.field_addsub(lf.FR, "add", a[..., :0],
                                a[..., :0]).shape == (4, 3, 8, 0)


# -----------------------------------------------------------------------------
# The kernel's arithmetic, executed from its PTX
# -----------------------------------------------------------------------------

def test_source_chains_are_all_parsed():
    assert sorted(CHAINS) == ["add12_carry", "add12_drop", "add8_carry",
                              "add8_drop", "sub12_borrow", "sub8_borrow"]
    check_operands_all_used(CHAINS)


def test_source_is_what_the_model_transcribes():
    """The C++ around the asm that `_field_op` below copies by hand."""
    body = function_body(SOURCE, "field_op")
    assert re.findall(r"\bC::(\w+)\(([^;]*)\);", body) == [
        ("add_carry", "r, y"), ("sub_borrow", "d, k"),
        ("sub_borrow", "r, OP == kSub ? y : x"), ("add_drop", "r, k")]
    assert "for (int i = 0; i < F::N; ++i) k[i] = F::p(i);" in body
    assert "const bool use_d = carry != 0 || borrow == 0;" in body
    assert "r[i] = use_d ? d[i] : r[i];" in body
    assert "r[i] = OP == kSub ? x[i] : 0u;" in body
    assert "k[i] &= mask;" in body
    kernel = SOURCE[SOURCE.index("field_addsub_kernel(const"):]
    assert "if (MASKED && mask[g * sm.group + l * sm.lane] == 0) {" in kernel
    assert "r[i] = x[i];" in kernel
    assert "enum Op { kAdd = 0, kSub = 1, kNeg = 2 };" in SOURCE
    assert kernels.FIELD_OPS == {"add": 0, "sub": 1, "neg": 2}
    # the constants the model takes from Python are the source's
    for spec in (lf.FR, lf.FQ):
        assert f"struct Chains<{spec.n_limbs}>" in SOURCE


def _words(v, n):
    return [(v >> (32 * i)) & M32 for i in range(n)]


def _int(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


def _field_op(n, p, op, x, y):
    """`field_op` of csrc/field_addsub.cu, the chains executed from PTX."""
    width = 8 if n == 8 else 12
    k = _words(p, n)
    if op == "add":
        r = list(x)
        env, _ = ptx_run_chain(CHAINS, f"add{width}_carry", r, y)
        d = list(r)
        env2, _ = ptx_run_chain(CHAINS, f"sub{width}_borrow", d, k)
        use_d = env["carry"] != 0 or env2["mask"] == 0
        return d if use_d else r
    r = list(x) if op == "sub" else [0] * n
    env, _ = ptx_run_chain(CHAINS, f"sub{width}_borrow", r,
                           y if op == "sub" else x)
    k = [w & env["mask"] for w in k]
    ptx_run_chain(CHAINS, f"add{width}_drop", r, k)
    return r


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_kernel_arithmetic_on_worst_case_operands(name, op):
    """Every pair of 0, 1, 2, p - 2, p - 1, R mod p and seeded values gives
    the canonical result; the plain version agrees on the same lanes."""
    _, spec = SPECS[name]
    n, p = spec.n_limbs, spec.modulus
    vals = [0, 1, 2, p - 2, p - 1, spec.R] + _values(spec, 6, 7)[4:]
    pairs = [(u, v) for u in vals for v in vals]
    got = [_int(_field_op(n, p, op, _words(u, n), _words(v, n)))
           for u, v in pairs]
    want = {"add": lambda u, v: (u + v) % p, "sub": lambda u, v: (u - v) % p,
            "neg": lambda u, v: (-u) % p}[op]
    assert got == [want(u, v) for u, v in pairs]
    a = spec.to_raw_array([u for u, _ in pairs], "cpu")
    b = spec.to_raw_array([v for _, v in pairs], "cpu")
    plain = kernels.field_addsub_plain(spec, op, a, None if op == "neg"
                                       else b)
    assert lf.raw_to_ints(spec, plain) == got


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_kernel_add_keeps_the_carry_of_operands_above_p(name):
    """The sum's carry out decides the subtraction (the reference's
    `_reduce_once` with its top row), so even operands up to 2^(32 L) - 1
    give the plain version's limbs."""
    _, spec = SPECS[name]
    n, p = spec.n_limbs, spec.modulus
    top = (1 << (32 * n)) - 1
    for u, v in ((top, top), (top, 1), (p, p), (top - p, p + 5)):
        got = _field_op(n, p, "add", _words(u, n), _words(v, n))
        a, b = (lf.u32_to_tensor(np.array(_words(w, n), np.uint32)[:, None],
                                 "cpu") for w in (u, v))
        plain = kernels.field_addsub_plain(spec, "add", a, b)
        assert lf.raw_to_ints(spec, plain) == [_int(got)]
