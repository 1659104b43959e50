"""What the redesigned `padd` and `window_fold` kernels assume, checked on
the CPU.

The CUDA sources cannot run here, so their arithmetic is modelled step by
step: the carry chains are NOT rewritten in Python but read out of
`zkvm_tpu_torch/csrc/fq_lazy.cuh` -- every inline-PTX statement is parsed and
executed on 32-bit words with an explicit carry flag -- and the functions
around them (`mul`, `add2q`, `sub2q`, `times_3_12`, `g1_add`, the six-lane
`g1_add_coop` with its shuffles, the Horner fold) are transcribed line by
line.  The model asserts the range the source states for every
intermediate and that no dropped carry is ever set.

What this file can and cannot see: an edit to an asm statement changes what
the model executes; an edit to the C++ around the asm does not, because that
part is a transcription by hand.  The test of the header's structure
(`test_header_structure_is_what_the_model_transcribes`) pins the few facts a
regular expression can read
(the order and operands of the chains inside `mul`, which array plays e and
o, the order of loads and products in `g1_add`, which table feeds which
shuffle in `g1_add_coop`), so that such an edit fails here until the model
is brought up to date.  The gate for the kernels themselves is the
bit-for-bit comparison on the card (`tests/test_torch_kernels_gpu.py`,
`chip_smoke.py`).

  (a) the multiply's schedule (even / odd columns) and the split of an
      addition over the lanes of a group equal a b / R mod q and the
      one-thread addition;
  (b) 12 t by four additions equals the product by 3b in the plain
      arithmetic, tolerance zero;
  (c) the lazily reduced addition keeps its ranges on worst-case operands
      and ends on `kernels.padd_plain`'s limbs and the reference's
      `_padd_jnp`, bit for bit;
  (d) `g1_ops.padd` reads strided views without a copy and equals the
      contiguous call; the wrapper raises on layouts the kernel cannot read.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ptx_model import (calls as _calls, check_operands_all_used,
                       function_body, parse_chains)
from ptx_model import run_chain as ptx_run_chain
from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.ops import g1_ops as rg1
from zkvm_tpu_torch.curves.g1 import G1Affine, G1Projective
from zkvm_tpu_torch.ops import g1_ops, kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FQ

torch.set_num_threads(1)

Q = FQ.modulus
R = 1 << 384
RINV = pow(R, -1, Q)
M32 = 0xFFFFFFFF
N = 12
NP0 = (-pow(Q, -1, 1 << 32)) % (1 << 32)
HEADER = (Path(kernels.CSRC) / "fq_lazy.cuh").read_text()


# -----------------------------------------------------------------------------
# The inline PTX of the header, parsed and executed
# -----------------------------------------------------------------------------

CHAINS = parse_chains(HEADER)


def run_chain(name: str, *args):
    """Execute the asm statement of the header's function `name`."""
    return ptx_run_chain(CHAINS, name, *args)


def test_header_chains_are_all_parsed():
    assert sorted(CHAINS) == ["add12", "mad6_carry", "mad6_drop", "merge",
                              "shift_mad6", "sub12"]
    check_operands_all_used(CHAINS)
    # the constants the model takes from Python are the header's
    two_q = [int(v, 16) for v in re.findall(
        r"0x[0-9a-f]{8}", HEADER[HEADER.index("q2(int i)"):][:400])]
    assert lf.limbs_to_int(np.array(two_q[:N], dtype=np.uint32)) == 2 * Q
    for table in ("0x10010210u", "0x00221000u", "0x00010000u", "0x43015143u",
                  "0x51340151u"):
        assert table in HEADER


def _body(name: str) -> str:
    return function_body(HEADER, name)


def test_header_structure_is_what_the_model_transcribes():
    """The C++ around the asm that the model below copies by hand."""
    mul_body = _body("mul")
    assert "uint32_t* e = (i & 1) ? od : ev;" in mul_body
    assert "uint32_t* o = (i & 1) ? ev : od;" in mul_body
    assert "ae[k] = a[2 * k];" in mul_body
    assert "ao[k] = a[2 * k + 1];" in mul_body
    assert "qe[k] = Fq::p(2 * k);" in mul_body
    assert "qo[k] = Fq::p(2 * k + 1);" in mul_body
    assert "const uint32_t w = b[i];" in mul_body
    assert "const uint32_t m = e[0] * Fq::NP0;" in mul_body
    chain_calls = re.findall(
        r"\b(shift_mad6|mad6_carry|mad6_drop|merge|copy)\(([^;]*)\);",
        mul_body)
    assert chain_calls == [("shift_mad6", "e[0], o, ao, w"),
                           ("mad6_carry", "e, o[N - 1], ae, w"),
                           ("mad6_drop", "o, qo, m"),
                           ("mad6_carry", "e, o[N - 1], qe, m"),
                           ("merge", "ev, od"), ("copy", "r, ev")]

    one = _body("g1_add")
    assert _calls(one, "ld") == ["a, 0", "b, 3", "c, 1", "d, 4", "a, 2",
                                 "b, 5", "c, 0", "d, 3"]
    assert _calls(one, "mul") == [
        "t0, a, b", "t1, c, d", "t3, a, b", "t2, a, b", "t4, c, d",
        "t5, a, b", "u, t3, t1", "v, t4, t5", "u, t1, z3", "v, t5, t0",
        "u, z3, t4", "v, t0, t3"]
    assert _calls(one, "add12") == ["a, c", "b, d", "c, a", "d, b", "a, c",
                                    "b, d"]
    assert _calls(one, "sub2q") == ["t3, t0", "t3, t1", "t4, t1", "t4, t2",
                                    "t5, t0", "t5, t2", "t1, t2", "u, v"]
    assert _calls(one, "add2q") == ["z3, t2", "u, v", "u, v"]
    assert _calls(one, "times_3_12") == ["u, t2, t2", "u, t5, t5",
                                         "t0, u, t0"]
    assert _calls(one, "st") == ["0, u", "1, u", "2, u"]

    coop = _body("g1_add_coop")
    assert "first = nibble(0x10010210u, role);" in coop
    assert "second = nibble(0x00221000u, role);" in coop
    assert _calls(coop, "pick3") == ["a, first, px, py, pz",
                                     "b, first, qx, qy, qz",
                                     "p, second, px, py, pz",
                                     "s, second, qx, qy, qz"]
    assert _calls(coop, "from_lane") == [
        "p, m, nibble(0x00010000u, role)", "s, m, nibble(0x00221000u, role)",
        "t6, p, 2", "a, p, nibble(0x43015143u, role)",
        "b, p, nibble(0x51340151u, role)", "c, s, 1", "px, m, 0", "py, m, 2",
        "pz, m, 4"]
    assert _calls(coop, "mul") == ["m, a, b", "m, a, b"]
    assert "sum = role >= 3 && role <= 5;" in coop
    assert "keep12 = role == 2 || role == 5;" in coop
    assert "keep3 = role == 0 || role == 6;" in coop
    assert "is1 = role == 1 || role == 7;" in coop
    assert "with_t1 = role == 0 || role == 2 || role == 6;" in coop
    assert "__shfl_xor_sync(0xffffffffu, m[i], 1, 8)" in coop
    assert "diff = role == 0;" in coop


# -----------------------------------------------------------------------------
# The header's functions, transcribed
# -----------------------------------------------------------------------------

def words(v: int) -> list[int]:
    assert 0 <= v < R
    return [(v >> (32 * i)) & M32 for i in range(N)]


def value(w) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(w))


Q_WORDS, Q2_WORDS = words(Q), words(2 * Q)


def add12(r, b):
    _, wrapped = run_chain("add12", r, b)
    return wrapped


def sub12(r, b) -> int:
    scalars, _ = run_chain("sub12", r, b)
    assert scalars["mask"] in (0, M32)
    return scalars["mask"]


def cond_sub(r, k):
    d = list(r)
    if not sub12(d, k):
        r[:] = d


def fold_2q(r):
    assert value(r) < 4 * Q
    cond_sub(r, Q2_WORDS)
    assert value(r) < 2 * Q


def reduce_q(r):
    assert value(r) < 2 * Q
    cond_sub(r, Q_WORDS)
    assert value(r) < Q


def add2q(r, b):
    assert value(r) < 2 * Q and value(b) < 2 * Q
    assert not add12(r, b)
    fold_2q(r)


def sub2q(r, b):
    assert value(r) < 2 * Q and value(b) < 2 * Q
    borrow = sub12(r, b)
    wrapped = add12(r, [k & borrow for k in Q2_WORDS])
    assert wrapped == bool(borrow)  # the carry out cancels the borrow
    assert value(r) < 2 * Q


def times_3_12(t):
    s = list(t)
    add2q(s, t)
    add2q(s, t)
    u = list(s)
    add2q(u, s)
    t3 = list(s)
    s = list(u)
    add2q(u, s)
    return t3, u


def mul(a, b):
    """`zk::lazy::mul`: rows of b, even and odd columns of a apart."""
    assert value(a) + Q < R
    ae, ao = a[0::2], a[1::2]
    qe, qo = Q_WORDS[0::2], Q_WORDS[1::2]
    ev, od = [0] * N, [0] * N
    for i in range(N):
        e, o = (od, ev) if i & 1 else (ev, od)
        w = b[i]
        if i == 0:
            for k in range(6):
                pe, po = ae[k] * w, ao[k] * w
                e[2 * k], e[2 * k + 1] = pe & M32, pe >> 32
                o[2 * k], o[2 * k + 1] = po & M32, po >> 32
        else:
            assert o[0] == 0  # last row's reduction cleared it
            scalars, wrapped = run_chain("shift_mad6", e[0], o, ao, w)
            assert not wrapped
            e[0] = scalars["ev0"]
            scalars, wrapped = run_chain("mad6_carry", e, o[N - 1], ae, w)
            assert not wrapped
            o[N - 1] = scalars["top"]
        m = (e[0] * NP0) & M32
        _, wrapped = run_chain("mad6_drop", o, qo, m)
        assert not wrapped  # the dropped carry is zero
        scalars, wrapped = run_chain("mad6_carry", e, o[N - 1], qe, m)
        assert not wrapped
        o[N - 1] = scalars["top"]
        assert e[0] == 0
    _, wrapped = run_chain("merge", ev, od)
    assert not wrapped
    # the bound the header states: (A B / 9.84 + 1) q
    assert value(ev) * R < value(a) * value(b) + Q * R
    return ev


def g1_add(p, q):
    """`zk::lazy::g1_add`: one thread, canonical outputs."""
    def ld(k):
        return list((p + q)[k])

    a, b = ld(0), ld(3)
    t0 = mul(a, b)
    c, d = ld(1), ld(4)
    t1 = mul(c, d)
    assert not add12(a, c) and not add12(b, d)
    t3 = mul(a, b)
    fold_2q(t3)
    sub2q(t3, t0)
    sub2q(t3, t1)
    a, b = ld(2), ld(5)
    t2 = mul(a, b)
    assert not add12(c, a) and not add12(d, b)
    t4 = mul(c, d)
    fold_2q(t4)
    sub2q(t4, t1)
    sub2q(t4, t2)
    c, d = ld(0), ld(3)
    assert not add12(a, c) and not add12(b, d)
    t5 = mul(a, b)
    fold_2q(t5)
    sub2q(t5, t0)
    sub2q(t5, t2)
    for t in (t0, t1, t2):
        assert value(t) * 100 < 141 * Q
    _, t2 = times_3_12(t2)
    z3 = list(t1)
    add2q(z3, t2)
    sub2q(t1, t2)
    _, t5 = times_3_12(t5)
    t0, _ = times_3_12(t0)
    out = []
    for (f1, f2), (g1, g2), op in (((t3, t1), (t4, t5), sub2q),
                                   ((t1, z3), (t5, t0), add2q),
                                   ((z3, t4), (t0, t3), add2q)):
        u, v = mul(f1, f2), mul(g1, g2)
        assert value(u) * 100 < 141 * Q and value(v) * 100 < 141 * Q
        op(u, v)
        reduce_q(u)
        out.append(u)
    return out


def nibble(table: int, role: int) -> int:
    return (table >> (4 * role)) & 7


def g1_add_coop(p, q, reduce: bool = False):
    """`zk::lazy::g1_add_coop` on the eight lanes of one group: every
    per-lane statement runs for all roles, shuffles read the other lanes'
    registers.  Returns the new point (identical on every lane)."""
    roles = range(8)

    def from_lane(regs, table=None, src=None):
        return [list(regs[nibble(table, r) if src is None else src])
                for r in roles]

    zero = [0] * N
    m = []
    for r in roles:
        first, second = nibble(0x10010210, r), nibble(0x00221000, r)
        is_sum = 3 <= r <= 5
        a, b = list(p[first]), list(q[first])
        assert not add12(a, p[second] if is_sum else zero)
        assert not add12(b, q[second] if is_sum else zero)
        v = mul(a, b)
        fold_2q(v)
        m.append(v)
    s1 = from_lane(m, table=0x00010000)
    s2 = from_lane(m, table=0x00221000)
    pp = []
    for r in roles:
        is_sum = 3 <= r <= 5
        sub2q(m[r], s1[r] if is_sum else zero)
        sub2q(m[r], s2[r] if is_sum else zero)
        m3, m12 = times_3_12(m[r])
        pp.append(m12 if r in (2, 5) else m3 if r in (0, 6) else list(m[r]))
    t6 = from_lane(pp, src=2)
    ss = []
    for r in roles:
        z3 = list(pp[r])
        add2q(z3, t6[r])
        s = list(pp[r])
        sub2q(s, t6[r])
        ss.append(s)
        if r in (1, 7):
            pp[r] = z3
    fa = from_lane(pp, table=0x43015143)
    fb = from_lane(pp, table=0x51340151)
    fc = from_lane(ss, src=1)
    m = []
    for r in roles:
        v = mul(fa[r], fc[r] if r in (0, 2, 6) else fb[r])
        assert value(v) * 100 < 141 * Q
        m.append(v)
    partner = [list(m[r ^ 1]) for r in roles]
    res = []
    for r in roles:
        d = list(m[r])
        sub2q(d, partner[r])
        add2q(m[r], partner[r])
        res.append(d if r == 0 else m[r])
    out = [list(res[0]), list(res[2]), list(res[4])]
    if reduce:
        for t in out:
            reduce_q(t)
    return out


# -----------------------------------------------------------------------------
# References in Python ints
# -----------------------------------------------------------------------------

def mont(v: int) -> int:
    return v * R % Q


def padd_ints(p, q):
    """RCB15 algorithm 7 (a = 0) on Montgomery residues, canonical."""
    mm = lambda a, b: a * b * RINV % Q
    x1, y1, z1 = p
    x2, y2, z2 = q
    b3 = mont(12)
    t0, t1, t2 = mm(x1, x2), mm(y1, y2), mm(z1, z2)
    t3 = (mm(x1 + y1, x2 + y2) - t0 - t1) % Q
    t4 = (mm(y1 + z1, y2 + z2) - t1 - t2) % Q
    t5 = (mm(x1 + z1, x2 + z2) - t0 - t2) % Q
    t6 = mm(t2, b3)
    z3, t1, y3 = (t1 + t6) % Q, (t1 - t6) % Q, mm(t5, b3)
    t03 = 3 * t0 % Q
    return ((mm(t3, t1) - mm(t4, y3)) % Q, (mm(t1, z3) + mm(y3, t03)) % Q,
            (mm(z3, t4) + mm(t03, t3)) % Q)


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


def _rand_below(rng, bound: int) -> int:
    return int.from_bytes(rng.bytes(56), "little") % bound


EDGE = [0, 1, Q - 1, 2 * Q - 1, R % Q, 4 * Q - 1]


# -----------------------------------------------------------------------------
# (a) the multiply's schedule, and the split of an addition over lanes
# -----------------------------------------------------------------------------

EDGE_IDS = ["0", "1", "q-1", "2q-1", "R_mod_q", "4q-1"]


@pytest.mark.parametrize("a", EDGE, ids=EDGE_IDS)
@pytest.mark.parametrize("b", EDGE + [R - 1], ids=EDGE_IDS + ["R-1"])
def test_mul_schedule_on_edge_operands(a, b):
    got = value(mul(words(a), words(b)))
    assert got % Q == a * b * RINV % Q
    assert got * R == a * b + (a * b * NP0_FULL % R) * Q


# m = -a b / q mod R: the exact (unreduced) Montgomery quotient
NP0_FULL = (-pow(Q, -1, R)) % R


def test_mul_schedule_on_seeded_operands():
    rng = np.random.default_rng(11)
    for bound_a, bound_b in ((Q, Q), (2 * Q, 2 * Q), (4 * Q, 4 * Q),
                             (8 * Q, R)):
        for _ in range(6):
            a, b = _rand_below(rng, bound_a), _rand_below(rng, bound_b)
            got = value(mul(words(a), words(b)))
            assert got % Q == a * b * RINV % Q
            if bound_a <= 2 * Q and bound_b <= 2 * Q:
                assert got * 100 < 141 * Q
            elif bound_b <= 4 * Q:
                assert got * 100 < 263 * Q


def test_mul_refuses_an_operand_the_proof_does_not_cover():
    with pytest.raises(AssertionError):
        mul(words(R - 1), words(5))


def test_addition_split_over_lanes_equals_one_thread():
    rng = np.random.default_rng(12)
    for case in range(3):
        p = [words(_rand_below(rng, Q)) for _ in range(3)]
        q = p if case == 2 else [words(_rand_below(rng, Q)) for _ in range(3)]
        assert g1_add_coop(p, q, reduce=True) == g1_add(p, q)


def test_fold_by_lane_groups_equals_plain_window_fold():
    """The kernel's loop at c = 2, W = 2, one set: the accumulator stays
    below 2q between additions and is reduced once, at the store."""
    c, w_count = 2, 2
    pts = _points(w_count, 13)
    sums = tuple(t.T.reshape(w_count, N, 1).contiguous()
                 for t in g1_ops.affine_to_device(pts, "cpu"))
    want = kernels.window_fold_plain(c, w_count, 1, *sums)
    rows = [lf.tensor_to_u32(t) for t in sums]  # [W, 12, 1] each
    acc = [words(0), words(mont(1)), words(0)]
    for w in range(w_count - 1, -1, -1):
        for _ in range(c):
            acc = g1_add_coop(acc, acc)
        acc = g1_add_coop(acc, [[int(v) for v in r[w, :, 0]] for r in rows])
        assert all(value(t) < 2 * Q for t in acc)
    for t in acc:
        reduce_q(t)
    got = lf.tensor_to_u32(want)
    assert [[int(v) for v in got[k, :, 0]] for k in range(3)] == acc


# -----------------------------------------------------------------------------
# (b) 12 t by four additions
# -----------------------------------------------------------------------------

def test_twelve_t_by_four_additions_equals_product_by_3b():
    rng = np.random.default_rng(14)
    vals = [0, 1, Q - 1, Q - 2, (Q + 1) // 2, Q // 12, Q // 12 + 1]
    vals += [_rand_below(rng, Q) for _ in range(57)]
    arr = np.stack([lf.int_to_limbs(v, N) for v in vals], axis=1)
    t = lf.split16(lf.u32_to_tensor(arr, "cpu"))
    add = lambda a, b: lf.add16(FQ, a, b)
    s = add(add(t, t), t)
    s = add(s, s)
    got = add(s, s)
    b3 = lf.const16(FQ, kernels.B3_MONT, t).expand(t.shape)
    assert torch.equal(got, lf.mont_mul16(FQ, t, b3))
    # the kernel's own chain on lazily reduced values, both results
    for v in (0, 1, Q - 1, Q, 2 * Q - 1, _rand_below(rng, 2 * Q)):
        t3, t12 = times_3_12(words(v))
        assert value(t3) % Q == 3 * v % Q and value(t12) % Q == 12 * v % Q
        assert value(t12) % Q == value(mul(words(v), words(mont(12)))) % Q


# -----------------------------------------------------------------------------
# (c) the lazily reduced addition
# -----------------------------------------------------------------------------

def test_lazy_addition_keeps_its_ranges_on_worst_case_operands():
    """Every coordinate 2q - 1 (the largest the source allows), and mixes
    of 0, q - 1, q and 2q - 1: the model's range assertions hold and the
    canonical outputs are the formula's."""
    big = 2 * Q - 1
    cases = [([big] * 3, [big] * 3), ([big, 0, Q], [Q - 1, big, 0]),
             ([0, 0, 0], [big, big, big]), ([Q, Q, Q], [Q - 1, Q, big])]
    rng = np.random.default_rng(15)
    cases += [([_rand_below(rng, 2 * Q) for _ in range(3)],
               [_rand_below(rng, 2 * Q) for _ in range(3)])
              for _ in range(3)]
    for p, q in cases:
        got = g1_add([words(v) for v in p], [words(v) for v in q])
        assert [value(t) for t in got] == list(padd_ints(p, q))
        coop = g1_add_coop([words(v) for v in p], [words(v) for v in q],
                           reduce=True)
        assert coop == got


def test_lazy_addition_ends_on_the_plain_version_and_the_reference():
    lhs, rhs = _points(7, 16), _points(7, 17)
    lhs[0] = G1Affine.identity()
    rhs[1] = G1Affine.identity()
    lhs[2] = rhs[2] = G1Affine.identity()
    rhs[3] = lhs[3]
    rhs[4] = -lhs[4]
    p = g1_ops.affine_to_device(lhs, "cpu")
    q = g1_ops.affine_to_device(rhs, "cpu")
    want = [lf.tensor_to_u32(t) for t in kernels.padd_plain(p, q)]
    to_ref = lambda pts: rg1.affine_to_device(
        [RG1Affine.identity() if a.infinity
         else RG1Affine(RFp(a.x.value), RFp(a.y.value)) for a in pts])
    ref = rg1._padd_jnp(to_ref(lhs), to_ref(rhs))
    for k in range(3):
        assert (lf.to_reference(lf.u32_to_tensor(want[k], "cpu"), FQ)
                == np.asarray(ref[k])).all()
    pu = [lf.tensor_to_u32(t) for t in p]
    qu = [lf.tensor_to_u32(t) for t in q]
    for lane in range(7):
        got = g1_add([[int(v) for v in t[:, lane]] for t in pu],
                     [[int(v) for v in t[:, lane]] for t in qu])
        assert got == [[int(v) for v in t[:, lane]] for t in want]


# -----------------------------------------------------------------------------
# (d) strided operands
# -----------------------------------------------------------------------------

def _field(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    a[..., -1, :] = rng.integers(0, int(FQ.p_limbs[-1]),
                                 size=a[..., -1, :].shape)
    return lf.u32_to_tensor(a, "cpu")


@pytest.fixture(scope="module")
def batch():
    return tuple(_field((2, N, 10), s) for s in (21, 22, 23))


def _spy(monkeypatch):
    """Record the operands `g1_ops.padd` hands to the kernel wrapper."""
    seen = []
    real = kernels.padd

    def padd(p, q, layouts=None):
        seen.append((p, q))
        return real(p, q, layouts)

    monkeypatch.setattr(kernels, "padd", padd)
    return seen


VIEWS = {
    "even_odd": lambda t: (t[..., 0::2], t[..., 1::2]),
    "halves": lambda t: (t[..., :5], t[..., 5:]),
    "scan_fix": lambda t: (t[..., :4], t[..., 2::2]),
    "limbs_innermost": lambda t: (
        t.transpose(1, 2).contiguous().transpose(1, 2)[..., :5], t[..., 5:]),
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_padd_reads_views_in_place(batch, monkeypatch, view):
    seen = _spy(monkeypatch)
    p = tuple(VIEWS[view](t)[0] for t in batch)
    q = tuple(VIEWS[view](t)[1] for t in batch)
    assert not p[0].is_contiguous() or not q[0].is_contiguous()
    got = g1_ops.padd(p, q)
    (sp, sq), = seen
    for given, handed in zip((*p, *q), (*sp, *sq)):
        assert handed.data_ptr() == given.data_ptr()  # no copy
        assert handed.stride() == given.stride()
    want = kernels.padd_plain(tuple(t.contiguous() for t in p),
                              tuple(t.contiguous() for t in q))
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.is_contiguous()


def test_padd_layout_of_views(batch):
    x = batch[0]
    assert kernels.padd_layout(batch) == (N * 10, 10, 1)
    assert kernels.padd_layout(tuple(t[..., 1::2] for t in batch)) == (
        N * 10, 10, 2)
    assert kernels.padd_layout(tuple(t[0] for t in batch)) == (0, 10, 1)
    four = tuple(t.reshape(2, 1, N, 10) for t in batch)
    assert kernels.padd_layout(four) == (N * 10, 10, 1)
    # two leading axes that do not collapse into one
    wide = torch.zeros((3, 4, N, 6), dtype=torch.int32)[:, :3]
    assert kernels.padd_layout((wide, wide, wide)) is None
    # coordinates with different strides
    assert kernels.padd_layout((x, x, x.transpose(1, 2).contiguous()
                                .transpose(1, 2))) is None


def test_padd_copies_only_what_the_kernel_cannot_read(batch, monkeypatch):
    seen = _spy(monkeypatch)
    x, y, z = batch
    mixed = (x, y.transpose(1, 2).contiguous().transpose(1, 2), z)
    got = g1_ops.padd(mixed, batch)
    (sp, sq), = seen
    assert all(t.is_contiguous() for t in sp)
    assert all(h.data_ptr() == g.data_ptr() for h, g in zip(sq, batch))
    for g, w in zip(got, kernels.padd_plain(batch, batch)):
        assert torch.equal(g, w)


def test_padd_wrapper_raises_on_layouts_it_does_not_take(batch):
    x, y, z = batch
    other = y.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="share one layout"):
        kernels.padd((x, other, z), batch)
    wide = torch.zeros((3, 4, N, 6), dtype=torch.int32)[:, :3]
    with pytest.raises(ValueError, match="share one layout"):
        kernels.padd((wide,) * 3, (wide,) * 3)
    # limb axis elsewhere
    moved = tuple(t.transpose(1, 2) for t in batch)
    with pytest.raises(ValueError, match="limb axis"):
        kernels.padd(moved, moved)
    with pytest.raises(ValueError, match="shape"):
        kernels.padd(batch, tuple(t[..., :5] for t in batch))
    with pytest.raises(TypeError):
        kernels.padd(tuple(t.to(torch.int64) for t in batch), batch)


def test_msm_pipeline_pieces_take_views():
    """The scan and the halving sum, whose every addition now reads
    strided operands, against a serial walk."""
    from zkvm_tpu_torch.ops import msm

    pts = _points(8, 24)
    t = g1_ops.affine_to_device(pts, "cpu")
    scan = msm._scan_padd(t)
    total = g1_ops.sum_lanes(t)
    acc = G1Projective.identity()
    for i, pt in enumerate(pts):
        acc = acc + pt.to_projective()
        assert g1_ops.device_to_projective(scan, i) == acc
    assert g1_ops.device_to_projective(total) == acc
