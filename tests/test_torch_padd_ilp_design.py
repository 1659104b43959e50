"""What the `padd_ilp` kernel (`zkvm_tpu_torch/csrc/padd_ilp.cu`, two
threads a point on `csrc/fq_lazy.cuh`) assumes, checked on the CPU.

The kernel runs padd.cu's lazily reduced arithmetic split over the two
threads of a pair: every statement runs on both threads, the half h only
selects operands and pointers, and a shuffle reads the partner's
registers.  The model below transcribes the kernel statement by statement
for both threads and executes every carry chain of the header word by
word (`tests/ptx_model.py`, through `test_torch_padd_design.py`'s
transcription of `mul`, `add2q`, `sub2q`, `fold_2q`, `times_3_12` and
`reduce_q`), asserting the range of every value and that no dropped carry
is set.  `test_kernel_source_is_what_the_model_transcribes` pins the
statements the model copies (loads, picks, shuffles, products, additions,
stores), so that an edit there fails here until the model is brought up
to date.  The model ends on `kernels.padd_plain`'s limbs and on the
one-thread `g1_add` model, on the edge and worst-case operands of
`test_torch_padd_design.py` and on identity, doubling and inverse lanes.
The gate for the kernel itself is the bit-for-bit comparison on the card
(`tests/test_torch_kernels_gpu.py`, `chip_smoke.py`).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from ptx_model import calls
from test_torch_padd_design import (Q, _points, _rand_below, add2q, add12,
                                    fold_2q, g1_add, mul, padd_ints,
                                    reduce_q, sub2q, times_3_12, value, words)
from zkvm_tpu_torch.curves.g1 import G1Affine
from zkvm_tpu_torch.ops import g1_ops, kernels
from zkvm_tpu_torch.ops import limb_field as lf

N = 12
SOURCE = (Path(kernels.CSRC) / "padd_ilp.cu").read_text()
KERNEL = SOURCE[SOURCE.index("padd_ilp_kernel("):SOURCE.index('extern "C"')]


def test_kernel_source_is_what_the_model_transcribes():
    assert re.findall(r"\bload\(([^;]*)\);", KERNEL) == [
        "a, (h ? z1p : x1p) + op, sp.limb", "b, (h ? z2p : x2p) + oq, sq.limb",
        "c, (h ? x1p : y1p) + op, sp.limb", "d, (h ? x2p : y2p) + oq, sq.limb",
        "a, y1p + op, sp.limb", "b, y2p + oq, sq.limb",
        "c, z1p + op, sp.limb", "d, z2p + oq, sq.limb"]
    assert calls(KERNEL, "mul") == ["m0, a, b", "m2, a, b", "m1, a, b",
                                    "u, a, b", "u, a, b", "v, a, b"]
    assert calls(KERNEL, "add12") == ["a, c", "b, d", "a, c", "b, d"]
    assert calls(KERNEL, "fold_2q") == ["m2", "m1"]
    assert "c[i] = h ? c[i] : 0u;" in KERNEL
    assert "d[i] = h ? d[i] : 0u;" in KERNEL
    assert calls(KERNEL, "partner") == ["r, m0", "r, m1", "r, m2", "v, u"]
    assert calls(KERNEL, "pick") == [
        "t0, h, r, m0", "t2, h, m0, r", "t1, h, r, m1", "t4, h, m1, r",
        "t3, h, r, m2", "t5, h, m2, r", "a, h, t5, t1", "b, h, t0, z3",
        "a, h, z3, t3", "b, h, t4, t1", "a, h, t0, t4", "b, h, t3, t5",
        "u, h, u, t1"]
    assert calls(KERNEL, "sub2q") == ["t3, t0", "t3, t1", "t4, t1", "t4, t2",
                                      "t5, t0", "t5, t2", "t1, t2", "t1, v"]
    assert calls(KERNEL, "add2q") == ["z3, t2", "u, v", "u, v"]
    assert calls(KERNEL, "times_3_12") == ["u, t2, t2", "u, t5, t5",
                                           "t0, u, t0"]
    assert calls(KERNEL, "copy") == ["z3, t1", "t1, u"]
    assert calls(KERNEL, "reduce_q") == ["u", "u"]
    assert ("y3p[oo + (i + (h ? N / 2 : 0)) * lanes] = h ? u[i + N / 2] : "
            "u[i];") in " ".join(KERNEL.split())
    assert "uint32_t* out = (h ? z3p : x3p) + oo;" in KERNEL
    assert "for (int i = 0; i < N; ++i) out[i * lanes] = u[i];" in KERNEL
    assert ("r[i] = __shfl_xor_sync(0xffffffffu, s[i], 1);"
            in SOURCE)
    assert "r[i] = h ? a[i] : b[i];" in SOURCE
    # the early return of a thread past the end comes after the last shuffle
    assert KERNEL.index("if (!live) return;") > KERNEL.index("partner(v, u)")


def pick(h, a, b):
    return list(a if h else b)


def padd_ilp_pair(p, q):
    """`padd_ilp_kernel` on the two threads of one point, coordinates in
    [0, 2q); returns the stored (X3, Y3, Z3)."""
    zero = [0] * N
    x1, y1, z1 = p
    x2, y2, z2 = q
    m0, m1, m2 = {}, {}, {}
    for h in (0, 1):  # stage 1, each thread
        a, b = pick(h, z1, x1), pick(h, z2, x2)
        m0[h] = mul(a, b)
        assert value(m0[h]) * 100 < 141 * Q
        c, d = pick(h, x1, y1), pick(h, x2, y2)
        assert not add12(a, c) and not add12(b, d)
        assert value(a) < 4 * Q and value(b) < 4 * Q
        m2[h] = mul(a, b)
        fold_2q(m2[h])
        a, b = list(y1), list(y2)
        c, d = pick(h, z1, zero), pick(h, z2, zero)
        assert not add12(a, c) and not add12(b, d)
        m1[h] = mul(a, b)
        fold_2q(m1[h])
    regs = {}
    for h in (0, 1):  # the exchange: each thread reads the partner's
        r = list(m0[1 - h])
        t0, t2 = pick(h, r, m0[h]), pick(h, m0[h], r)
        r = list(m1[1 - h])
        t1, t4 = pick(h, r, m1[h]), pick(h, m1[h], r)
        r = list(m2[1 - h])
        t3, t5 = pick(h, r, m2[h]), pick(h, m2[h], r)
        sub2q(t3, t0)
        sub2q(t3, t1)
        sub2q(t4, t1)
        sub2q(t4, t2)
        sub2q(t5, t0)
        sub2q(t5, t2)
        _, t2 = times_3_12(t2)
        z3 = list(t1)
        add2q(z3, t2)
        sub2q(t1, t2)
        _, t5 = times_3_12(t5)
        t0, _ = times_3_12(t0)
        for t in (t0, t1, t3, t4, t5, z3):
            assert value(t) < 2 * Q
        regs[h] = dict(t0=t0, t1=t1, t3=t3, t4=t4, t5=t5, z3=z3)
    first = {}
    for h in (0, 1):
        g = regs[h]
        first[h] = mul(pick(h, g["t5"], g["t1"]), pick(h, g["t0"], g["z3"]))
        assert value(first[h]) * 100 < 141 * Q
    ys = {}
    for h in (0, 1):
        u = list(first[h])
        add2q(u, first[1 - h])
        reduce_q(u)
        ys[h] = u
    assert ys[0] == ys[1]  # both threads hold Y3
    y3 = ys[0][:N // 2] + ys[1][N // 2:]  # each stores six limbs
    res = {}
    for h in (0, 1):
        g = regs[h]
        u = mul(pick(h, g["z3"], g["t3"]), pick(h, g["t4"], g["t1"]))
        v = mul(pick(h, g["t0"], g["t4"]), pick(h, g["t3"], g["t5"]))
        assert value(u) * 100 < 141 * Q and value(v) * 100 < 141 * Q
        t1 = list(u)
        sub2q(t1, v)
        add2q(u, v)
        u = pick(h, u, t1)
        reduce_q(u)
        res[h] = u
    return [res[0], y3, res[1]]


def test_two_threads_keep_their_ranges_on_worst_case_operands():
    """Every coordinate 2q - 1 (the largest the source allows), mixes of
    0, q - 1, q and 2q - 1, and seeded values below 2q: the model's range
    assertions hold, and the stored limbs are the formula's and the
    one-thread model's."""
    big = 2 * Q - 1
    cases = [([big] * 3, [big] * 3), ([big, 0, Q], [Q - 1, big, 0]),
             ([0, 0, 0], [big, big, big]), ([Q, Q, Q], [Q - 1, Q, big]),
             ([big, big, big], [big, big, big])]
    rng = np.random.default_rng(41)
    cases += [([_rand_below(rng, 2 * Q) for _ in range(3)],
               [_rand_below(rng, 2 * Q) for _ in range(3)])
              for _ in range(3)]
    for p, q in cases:
        pw, qw = [words(v) for v in p], [words(v) for v in q]
        got = padd_ilp_pair(pw, qw)
        assert [value(t) for t in got] == list(padd_ints(p, q))
        assert got == g1_add(pw, qw)


@pytest.mark.parametrize("lane", range(7))
def test_two_threads_end_on_the_plain_version(lane):
    """Identity + P, P + identity, identity + identity, P + P, P + (-P) and
    two sums of seeded points, as the kernel reads them from the
    contiguous tensors."""
    lhs, rhs = _points(7, 42), _points(7, 43)
    lhs[0] = G1Affine.identity()
    rhs[1] = G1Affine.identity()
    lhs[2] = rhs[2] = G1Affine.identity()
    rhs[3] = lhs[3]
    rhs[4] = -lhs[4]
    p = g1_ops.affine_to_device(lhs, "cpu")
    q = g1_ops.affine_to_device(rhs, "cpu")
    want = [lf.tensor_to_u32(t) for t in kernels.padd_ilp_plain(p, q)]
    pu = [lf.tensor_to_u32(t) for t in p]
    qu = [lf.tensor_to_u32(t) for t in q]
    got = padd_ilp_pair([[int(v) for v in t[:, lane]] for t in pu],
                        [[int(v) for v in t[:, lane]] for t in qu])
    assert got == [[int(v) for v in t[:, lane]] for t in want]
