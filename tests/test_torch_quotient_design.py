"""What the `quotient` kernel (`zkvm_tpu_torch/csrc/quotient.cu`) computes,
checked on the CPU.

The CUDA source cannot run here.  A lane runs on two threads: each computes
half of the widgets into its own sum, and the second adds the first's
(`meet`), the public inputs, and multiplies by Z_H^-1.  The programs of
the two halves and of the combine are written in a few statements
(`kernels.QUOTIENT_STATEMENTS`: load an operand, read a table entry, store,
take the other half's sum, product, sum, difference, negation, dot
products of two to five pairs) and two functions made of them, so the
model does not copy them: it reads them out of the source
(`kernels.quotient_program`) and executes them statement by statement, each
half in its own frame, on the carry chains of
`csrc/fr_lazy.cuh` (`tests/ptx_model.py`, through
`test_torch_hades_design.py`'s transcription of `mul`, `dot`, `reduce_r`,
`reduce_dot` and `add_r` and `test_torch_ntt_design.py`'s of `sub_r`) or on
the same values in integers (the exact Montgomery quotient that `mul` and
`dot` return, which those files hold against the chains).  Every value is
asserted canonical and every product and dot product inside its stated
range.  The C++ of each statement is pinned by
`test_kernel_source_is_what_the_model_transcribes`, with which operands
each half reads and how the halves meet; the launch (threads, the pairing,
the operands' strides) is not modelled.

The model, `quotient_kernel.quotient_pointwise` on the CPU (the kernel's
plain version) and `zkvm_tpu`'s `quotient_numerator` + `pointwise_divide`
on the JAX CPU backend take the same numpy-seeded canonical operands (lanes
0, 1 and 2 of every operand at 0, 1 and r - 1) at L = 2^5 (chains) and
2^8 (integers): every word equal, tolerance 0.  The gate for the kernel
itself is the bit-for-bit comparison on the card
(`tests/test_torch_kernels_gpu.py`, `chip_smoke.py`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import zkvm_tpu.ops.limb_field as rlf
from ptx_model import calls, function_body
from test_torch_hades_design import add_r, dot, mul, reduce_dot, reduce_r
from test_torch_hades_design import value as words_value
from test_torch_hades_design import words
from test_torch_ntt_design import sub_r
from zkvm_tpu.ops import quotient_kernel as rqk
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import quotient_kernel as qk

torch.set_num_threads(1)

P = lf.FR.modulus
R = 1 << 256
NP_FULL = (-pow(P, -1, R)) % R
SOURCE = (Path(kernels.CSRC) / "quotient.cu").read_text()
SELECTORS = kernels.QUOTIENT_OPERANDS[:15]
WIRES = ("a", "b", "c", "d", "a_w", "b_w", "d_w")


# -----------------------------------------------------------------------------
# The source's structure
# -----------------------------------------------------------------------------

def _enum(name: str) -> list[str]:
    body = re.search(r"enum %s \{(.*?)\};" % name, SOURCE, re.S).group(1)
    return [e.strip() for e in body.split(",")]


def test_enums_are_the_wrappers_orders():
    assert _enum("Operand") == [f"k_{n}" for n in kernels.QUOTIENT_OPERANDS
                                ] + ["kOperands"]
    assert _enum("Entry") == [f"t_{n}" for n in kernels.QUOTIENT_TABLE
                              ] + ["kEntries"]
    assert qk.CHALLENGES == ("alpha", "beta", "gamma", "range_sep",
                             "logic_sep", "fixed_sep", "var_sep")
    # the plonk layer's selector and sigma tables, in the kernel's order
    from zkvm_tpu_torch.plonk import quotient
    assert tuple(n for _, n in quotient._SELECTOR_PAIRS) == SELECTORS


def test_kernel_source_is_what_the_model_transcribes():
    """The C++ of each statement, which the model executes by name."""
    body = re.search(r"__device__ __noinline__ Word8 product\(Word8 a, "
                     r"Word8 b\) \{(.*?)\n\}", SOURCE, re.S).group(1)
    assert re.findall(r"zk::frl::(\w+)\(([^;]*)\);", body) == [
        ("mul", "r.w, a.w, b.w"), ("reduce_r", "r.w")]
    assert body.rstrip().endswith("return r;")
    body = " ".join(function_body(SOURCE, "fmul").split())
    assert ("for (int i = 0; i < N; ++i) { x.w[i] = a[i]; y.w[i] = b[i]; } "
            "const Word8 t = product(x, y); #pragma unroll for (int i = 0; i "
            "< N; ++i) r[i] = t.w[i];") in body
    for name, step in (("fadd", "add_r"), ("fsub", "sub_r")):
        body = function_body(SOURCE, name)
        assert "for (int i = 0; i < N; ++i) t[i] = a[i];" in body
        assert re.findall(r"zk::frl::(\w+)\(([^;]*)\);", body) == [
            (step, "t, b")]
        assert "for (int i = 0; i < N; ++i) r[i] = t[i];" in body
    body = function_body(SOURCE, "fneg")
    assert "for (int i = 0; i < N; ++i) t[i] = 0;" in body
    assert re.findall(r"zk::frl::(\w+)\(([^;]*)\);", body) == [
        ("sub_r", "t, a")]
    body = " ".join(function_body(SOURCE, "fdot").split())
    assert ("zk::frl::dot<K>( t, [&](int j) { return x[j]; }, [&](int j, "
            "int i) { return y[j][i]; });") in body
    assert calls(body, "zk::frl::reduce_dot") == ["r, t"]
    for k in (2, 3, 4, 5):
        body = function_body(SOURCE, f"fdot{k}")
        xs = ", ".join(f"x{j}" for j in range(k))
        ys = ", ".join(f"y{j}" for j in range(k))
        assert f"const uint32_t* x[{k}] = {{{xs}}};" in body
        assert f"const uint32_t* y[{k}] = {{{ys}}};" in body
        assert calls(body, f"fdot<{k}>") == ["r, x, y"]
    kernel = " ".join(SOURCE[SOURCE.index("quotient_kernel("):
                             SOURCE.index("// ---- the first half")].split())
    for line in (
            "const int half = (threadIdx.x >> kPairBit) & 1;",
            "const int slot = ((threadIdx.x >> (kPairBit + 1)) << kPairBit) "
            "| (threadIdx.x & ((1 << kPairBit) - 1));",
            "const long long pair = (long long)blockIdx.x * kPairs + slot;",
            "const long long lane = pair < lanes ? pair : lanes - 1;",
            # the staged operands, copied by the pair before the barrier
            "for (int j = half; j < kStages; j += 2) { const int k = "
            "staged(j); #pragma unroll for (int l = 0; l < N; ++l) "
            "stage[j][l][slot] = __ldg(in.p[k] + l * in.limb_stride[k] + "
            "lane); } __syncthreads();",
            "const int j = stage_of(k); #pragma unroll for (int l = 0; l < "
            "N; ++l) x[l] = j >= 0 ? stage[j][l][slot] : __ldg(in.p[k] + l "
            "* in.limb_stride[k] + lane);",
            "for (int l = 0; l < N; ++l) x[l] = c_table[k * N + l];",
            "if (pair < lanes) { #pragma unroll for (int l = 0; l < N; ++l) "
            "out[l * lanes + pair] = x.p[l]; }",
            "for (int l = 0; l < N; ++l) x[l] = park[0][slot][l];",
            # a statement copies its operands in and its result out
            "for (int l = 0; l < N; ++l) s[l] = from[l];",
            "for (int l = 0; l < N; ++l) to[l] = s[l];",
            "const Park total{park[half][slot]}; if (half == 0) {"):
        assert line in kernel, line
    # every statement of the program is a call of stmt's function of its
    # name on copies of its operands, and its result put back
    for name, params in (("fmul", "a, b"), ("fadd", "a, b"),
                         ("fsub", "a, b"), ("fneg", "a"),
                         ("minus4", "hi, lo"), ("delta", "f, two"),
                         ("fdot2", "x0, y0, x1, y1"),
                         ("fdot3", "x0, y0, x1, y1, x2, y2"),
                         ("fdot4", "x0, y0, x1, y1, x2, y2, x3, y3"),
                         ("fdot5", "x0, y0, x1, y1, x2, y2, x3, y3, x4, y4")):
        args = params.split(", ")
        found = re.search(r"auto %s = \[&\]\((.*?)\) \{(.*?)\n  \};" % name,
                          SOURCE, re.S)
        assert found, name
        assert " ".join(found.group(1).split()) == "auto r, " + ", ".join(
            f"auto {a}" for a in args), name
        body = found.group(2)
        gets = re.findall(r"get\((\w+), (\w+)\);", body)
        assert [g[1] for g in gets] == args, name
        assert calls(body, f"stmt::{name}") == [
            "t, " + ", ".join(g[0] for g in gets)], name
        assert body.rstrip().endswith("put(r, t);"), name
    # the parked values: slot 0 and 1 the two halves' sums, which the
    # combine meets at slot 0; each other slot named once, in one half
    parked = re.findall(r"const Park (\w+)\{park\[(\w+)\]\[slot\]\};",
                        SOURCE)
    assert parked == [("total", "half"), ("cd", "2"), ("x1", "3"),
                      ("x2", "4"), ("x1", "5")]
    assert re.search(r"constexpr int kParked = 6;", SOURCE)
    # the staged operands are those a lane reads more than once
    switch = SOURCE[SOURCE.index("constexpr int staged(int j)"):
                    SOURCE.index("constexpr int stage_of(int k)")]
    staged = re.findall(r"return k_(\w+);", switch)
    assert len(staged) == int(re.search(r"constexpr int kStages = (\d+);",
                                        SOURCE).group(1))
    # the first half's sum reaches the second through the block's barrier
    between = " ".join(SOURCE[SOURCE.index("// ---- end of the first half"):
                              SOURCE.index("// ---- the combine")].split())
    assert between.index("} else {") < between.index("// ---- the second")
    assert re.search(r"// ---- end of the second half of a lane ---- \} "
                     r"__syncthreads\(\); if \(half == 1\) \{", between)
    assert re.search(r"kPairs = kThreads / 2;", SOURCE)
    assert "zk::blocks_for(lanes, kPairs)" in SOURCE
    assert "cudaMemcpyToSymbolAsync(" in SOURCE
    # the programs and their two functions are made of the statements only
    parts, functions = kernels.quotient_program()
    assert list(parts) == ["first", "second", "combine"]
    assert sorted(functions) == ["delta", "minus4"]
    for stmts in list(parts.values()) + [f[1] for f in functions.values()]:
        for op, _ in stmts:
            assert op in kernels.QUOTIENT_STATEMENTS or op in functions, op
    # which operands each part reads: the seven wires in both halves, q_c,
    # q_l and q_r in the first (each again in a later widget: these are the
    # staged ones), every other selector, sigma and column once in the whole
    # lane, the public inputs and Z_H^-1 in the combine; the combine meets
    # the first half's sum first and stores the lane once, last
    loads = {name: {args[1][2:] for op, args in stmts if op == "ld"}
             for name, stmts in parts.items()}
    wires = set(WIRES)
    assert loads["first"] == wires | {"q_m", "q_l", "q_r", "q_o", "q_f",
                                      "q_c", "q_arith", "q_fixed_group_add",
                                      "q_logic"}
    assert loads["second"] == wires | {
        "q_variable_group_add", "q_range", "s_sigma_1", "s_sigma_2",
        "s_sigma_3", "s_sigma_4", "z", "z_w", "l1_alpha_sq", "linear"}
    assert loads["combine"] == {"pi", "v_h_inv"}
    assert set().union(*loads.values()) == set(kernels.QUOTIENT_OPERANDS)
    every = [args[1][2:] for stmts in parts.values() for op, args in stmts
             if op == "ld"]
    again = {n for n in every if every.count(n) > 1}
    assert again == wires | {"q_c", "q_l", "q_r"} == set(staged)
    assert [op for op, _ in parts["combine"]] == [
        "meet", "fadd", "ld", "fadd", "ld", "fmul", "st"]
    assert parts["combine"][0][1] == ["t"] and parts["combine"][-1][1] == [
        "total"]
    for name in ("first", "second"):
        ops = [op for op, _ in parts[name]]
        assert "st" not in ops and "meet" not in ops
        assert "total" in {args[0] for _, args in parts[name]}
    assert all(op not in ("ld", "st", "meet")
               for f in functions.values() for op, _ in f[1])


def test_its_multiply_adds_and_the_chains():
    """49 products and 11 dot products a lane, 9,648 multiply-adds in the
    first half, 9,856 in the second and 272 in its combine, where the chain
    (the kernel's plain version) takes 113 products of full width and 12 of
    [8, 1] challenge columns."""
    parts, functions = kernels.quotient_program()

    def ops(stmts):
        out = []
        for op, _ in stmts:
            out += ops(functions[op][1]) if op in functions else [op]
        return out

    flat = [op for stmts in parts.values() for op in ops(stmts)]
    assert flat.count("fmul") == 49
    assert sorted(op for op in flat if op.startswith("fdot")) == (
        ["fdot2"] + ["fdot3"] * 6 + ["fdot4"] * 2 + ["fdot5"] * 2)
    assert kernels.quotient_multiply_adds() == 19776
    assert [kernels.quotient_multiply_adds(p) for p in parts] == [
        9648, 9856, 272]
    assert kernels.dot_multiply_adds(1) == 272
    assert kernels.dot_multiply_adds(5) == 784  # hades.cu's MDS row
    seen = []

    def mul(a, b):
        seen.append(max(a.shape[-1], b.shape[-1]))
        return qk.PLAIN.mul(a, b)

    operands, table, _ = _operands(2, 3)
    qk.quotient_chain([operands[n] for n in kernels.QUOTIENT_OPERANDS],
                      table, qk.Arithmetic(mul, qk.PLAIN.add, qk.PLAIN.sub))
    assert seen.count(4) == 113 and seen.count(1) == 12
    assert 113 * 272 == 30736


def test_the_two_halves_are_balanced():
    """The two threads of a lane take within 5% of the same multiply-adds,
    the second with its combine, and each more than two fifths of the
    lane's."""
    first = kernels.quotient_multiply_adds("first")
    second = (kernels.quotient_multiply_adds("second")
              + kernels.quotient_multiply_adds("combine"))
    assert abs(first - second) * 20 <= max(first, second)
    assert min(first, second) * 5 > 2 * kernels.quotient_multiply_adds()


# -----------------------------------------------------------------------------
# The model: the program read out of the source, executed
# -----------------------------------------------------------------------------

class Chains:
    """The statements on fr_lazy.cuh's carry chains, on eight-word lists."""

    @staticmethod
    def lift(v: int):
        return words(v)

    @staticmethod
    def lower(x) -> int:
        return words_value(x)

    @staticmethod
    def fmul(a, b):
        assert words_value(a) < P and words_value(b) < P
        t = mul(a, b)
        assert words_value(t) * 1000 < 1453 * P
        reduce_r(t)
        return t

    @staticmethod
    def fadd(a, b):
        t = list(a)
        add_r(t, b)
        return t

    @staticmethod
    def fsub(a, b):
        t = list(a)
        sub_r(t, b)
        return t

    @staticmethod
    def fneg(a):
        t = [0] * 8
        sub_r(t, a)
        return t

    @staticmethod
    def fdot(xs, ys):
        assert all(words_value(v) < P for v in xs + ys)
        t = dot(list(xs), lambda j, i: ys[j][i])
        assert words_value(t) * 100 < 327 * P
        return reduce_dot(t)


class Integers:
    """The same statements on Python integers: the exact Montgomery
    quotient the chains compute, reduced as they reduce it."""

    lift = lower = staticmethod(lambda v: v)

    @staticmethod
    def _redc(total: int) -> int:
        return (total + (total * NP_FULL % R) * P) // R

    @classmethod
    def fmul(cls, a, b):
        assert a < P and b < P
        t = cls._redc(a * b)
        assert t * 1000 < 1453 * P
        return t - P if t >= P else t

    @staticmethod
    def fadd(a, b):
        assert a < P and b < P
        return a + b - P if a + b >= P else a + b

    @staticmethod
    def fsub(a, b):
        assert a < P and b < P
        return a - b + P if a < b else a - b

    @staticmethod
    def fneg(a):
        assert a < P
        return (P - a) % P

    @classmethod
    def fdot(cls, xs, ys):
        assert all(v < P for v in xs + ys)
        t = cls._redc(sum(x * y for x, y in zip(xs, ys)))
        assert t * 100 < 327 * P
        if t >= 2 * P:
            t -= 2 * P
        return t - P if t >= P else t


def run_lane(arith, operands: list[int], table: list[int]) -> int:
    """The programs of a lane on one lane's Montgomery operands (in the order
    of QUOTIENT_OPERANDS) and the table's entries: each half in its own
    frame (its thread's registers), then the combine in the second's, where
    `meet` reads the first's `total`."""
    parts, functions = kernels.quotient_program()
    out = []

    def execute(stmts, frame, other=None):
        def get(name):
            return frame[name][0]

        def put(name, v):
            frame.setdefault(name, [None])[0] = v

        for op, args in stmts:
            if op == "ld":
                put(args[0], arith.lift(operands[
                    kernels.QUOTIENT_OPERANDS.index(args[1][2:])]))
            elif op == "tb":
                put(args[0], arith.lift(table[
                    kernels.QUOTIENT_TABLE.index(args[1][2:])]))
            elif op == "st":
                out.append(arith.lower(get(args[0])))
            elif op == "meet":
                put(args[0], other["total"][0])
            elif op in ("fmul", "fadd", "fsub"):
                put(args[0], getattr(arith, op)(get(args[1]), get(args[2])))
            elif op == "fneg":
                put(args[0], arith.fneg(get(args[1])))
            elif op.startswith("fdot"):
                k = int(op[4:])
                assert len(args) == 1 + 2 * k
                put(args[0], arith.fdot([get(a) for a in args[1::2]],
                                        [get(a) for a in args[2::2]]))
            else:
                params, body = functions[op]
                # a parameter is the caller's array: writes go to it
                execute(body, {p: frame.setdefault(a, [None])
                               for p, a in zip(params, args)})

    first, second = {}, {}
    execute(parts["first"], first)
    execute(parts["second"], second)
    execute(parts["combine"], second, first)
    assert len(out) == 1
    return out[0]


# -----------------------------------------------------------------------------
# Operands, the plain version and the reference
# -----------------------------------------------------------------------------

def _ints(n, rng):
    words64 = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % P
            for row in words64]


def _operands(log_size: int, seed: int):
    """Canonical operands (name -> [8, L] Montgomery tensor), the challenge
    table and the challenges' values; lanes 0, 1, 2 of every operand are 0,
    1 and r - 1."""
    size = 1 << log_size
    rng = np.random.default_rng(seed)
    vals = {}
    for name in kernels.QUOTIENT_OPERANDS:
        v = _ints(size, rng)
        v[:3] = [0, 1, P - 1]
        vals[name] = v
    chals = dict(zip(qk.CHALLENGES, _ints(7, rng)))
    operands = {n: lf.FR.to_mont_array(v, "cpu") for n, v in vals.items()}
    return operands, qk.challenge_table(chals, "cpu"), chals


def _pointwise(operands, chals):
    return qk.quotient_pointwise(
        {n: operands[n] for n in SELECTORS},
        tuple(operands[w] for w in WIRES), operands["z"], operands["z_w"],
        operands["pi"], operands["l1_alpha_sq"], operands["linear"],
        operands["v_h_inv"], chals)


def _reference(operands, chals) -> np.ndarray:
    """zkvm_tpu's two jitted programs on the same values."""
    ref = {n: lf.to_reference(t, lf.FR) for n, t in operands.items()}
    rchal = {n: rlf.FR.const_mont(v) for n, v in chals.items()}
    num = rqk.quotient_numerator(
        {n: ref[n] for n in SELECTORS}, tuple(ref[w] for w in WIRES),
        ref["z"], ref["z_w"], ref["pi"], ref["l1_alpha_sq"], ref["linear"],
        rchal)
    return np.asarray(rqk.pointwise_divide(num, ref["v_h_inv"]))


def _lane(t: torch.Tensor, j: int) -> int:
    return lf.limbs_to_int(lf.tensor_to_u32(t)[:, j])


@pytest.fixture(scope="module", params=[5, 8], ids=["2^5", "2^8"])
def case(request):
    """(log size, operands, table, plain result) for the model, held against
    the reference here once."""
    log_size = request.param
    operands, table, chals = _operands(log_size, 40 + log_size)
    got = _pointwise(operands, chals)
    assert got.shape == (8, 1 << log_size) and got.is_contiguous()
    assert (lf.to_reference(got, lf.FR) == _reference(operands, chals)).all()
    return log_size, operands, table, got


def _model_lanes(case, arith, lanes):
    _, operands, table, got = case
    entries = [lf.limbs_to_int(row) for row in lf.tensor_to_u32(table)]
    for j in lanes:
        lane = [_lane(operands[n], j) for n in kernels.QUOTIENT_OPERANDS]
        assert run_lane(arith, lane, entries) == _lane(got, j), j


def test_model_equals_plain_and_reference(case):
    """Every lane in integers; at 2^5 every lane on the chains too."""
    log_size = case[0]
    _model_lanes(case, Integers, range(1 << log_size))
    if log_size == 5:
        _model_lanes(case, Chains, range(1 << log_size))


def test_table_is_the_challenges_powers():
    chals = dict(zip(qk.CHALLENGES, (3, 5, 7, 11, 13, 17, 19)))
    vals = dict(zip(kernels.QUOTIENT_TABLE, qk.challenge_values(chals)))
    assert vals["range_2"] == 11 * pow(11, 4, P) % P
    assert vals["logic_4"] == 13 * pow(13, 8, P) % P
    assert vals["var_1"] == 19 ** 3 % P and vals["fixed_0"] == 17
    assert vals["neg_alpha"] == P - 3 and vals["jubjub_d"] < P
    assert vals["neg_eighty_one"] == P - 81 and vals["eighty_three"] == 83
    table = lf.tensor_to_u32(qk.challenge_table(chals, "cpu"))
    assert table.shape == (len(kernels.QUOTIENT_TABLE), 8)
    assert [lf.limbs_to_int(row) for row in table] == [
        v * lf.FR.R % P for v in vals.values()]


# -----------------------------------------------------------------------------
# The wrapper on the CPU
# -----------------------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    operands, table, chals = _operands(4, 9)
    ordered = [operands[n] for n in kernels.QUOTIENT_OPERANDS]
    before = dict(kernels.LAUNCHES)
    got = kernels.quotient(ordered, table)
    assert torch.equal(got, kernels.quotient_plain(ordered, table))
    assert torch.equal(got, _pointwise(operands, chals))
    # the chain on the arithmetic the path used before: the same words
    assert torch.equal(got, qk.quotient_chain(ordered, table))
    assert kernels.LAUNCHES == before  # the CPU launches no kernel


def test_wrapper_reads_a_shards_slice_and_refuses_what_it_cannot():
    """A shard's part of a global tensor (its limb rows strided) is taken
    as it is; other layouts, shapes and tables raise."""
    operands, table, chals = _operands(5, 10)
    halves = [t[:, 16:] for t in (operands[n]
                                  for n in kernels.QUOTIENT_OPERANDS)]
    assert not halves[0].is_contiguous() and halves[0].stride() == (32, 1)
    want = kernels.quotient([t.contiguous() for t in halves], table)
    assert torch.equal(kernels.quotient(halves, table), want)
    assert torch.equal(want, _pointwise(operands, chals)[:, 16:])
    ordered = [operands[n] for n in kernels.QUOTIENT_OPERANDS]
    with pytest.raises(ValueError, match="28"):
        kernels.quotient(ordered[:-1], table)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.quotient([t[:, ::2] for t in ordered], table)
    with pytest.raises(ValueError, match=r"\[8, 32\]"):
        kernels.quotient(ordered[:-1] + [ordered[-1][:, :16]], table)
    with pytest.raises(TypeError, match="int32"):
        kernels.quotient(ordered[:-1] + [ordered[-1].long()], table)
    with pytest.raises(ValueError, match="table"):
        kernels.quotient(ordered, table[:-1])
