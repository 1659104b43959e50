"""What the redesigned `hades_permute` kernels and the Fr chain of `mont_pow`
assume, checked on the CPU.

The CUDA sources cannot run here, so their arithmetic is modelled step by
step: the carry chains are NOT rewritten in Python but read out of
`zkvm_tpu_torch/csrc/fr_lazy.cuh` -- every inline-PTX statement is parsed and
executed on 32-bit words with an explicit carry flag (`tests/ptx_model.py`,
shared with `test_torch_padd_design.py`) -- and the functions around them
(`dot`, `mul`, `reduce_r`, `add_r`, `reduce_dot`, `sbox`, one round of the
one-thread kernel, one round of the five-thread kernel with its shuffles,
one bit of the Fr power chain) are transcribed line by line.  The model
asserts the range the header states for every intermediate and that no
dropped carry is ever set.

What this file can and cannot see: an edit to an asm statement changes what
the model executes; an edit to the C++ around the asm does not, because that
part is a transcription by hand.  `test_sources_are_what_the_model_
transcribes` pins the few facts a regular expression can read (the order and
operands of the chains inside `dot`, which array plays e and o, the steps of
`sbox` and `reduce_dot`, which operand of a row is the multiplicand in each
kernel, the shuffle's source lane, the select of a partial round, the order
of one bit of the power chain), so that such an edit fails here until the
model is brought up to date.  Launch shapes, the lane arithmetic of the
five-thread kernel's prologue and the dispatch between the two kernels are
not modelled.  The gate for the kernels themselves is the bit-for-bit
comparison on the card (`tests/test_torch_kernels_gpu.py`, `chip_smoke.py`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ptx_model import (calls, check_operands_all_used, function_body,
                       parse_chains)
from ptx_model import run_chain as ptx_run_chain
from zkvm_tpu.hashes import hades_permute as ref_hades_permute
from zkvm_tpu_torch.ops import kernels, poseidon
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FR

torch.set_num_threads(1)

P = FR.modulus
R = 1 << 256
RINV = pow(R, -1, P)
M32 = 0xFFFFFFFF
N = 8
NP0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
HEADER = (Path(kernels.CSRC) / "fr_lazy.cuh").read_text()
HADES = (Path(kernels.CSRC) / "hades.cu").read_text()
MONT = (Path(kernels.CSRC) / "mont_mul.cu").read_text()
CHAINS = parse_chains(HEADER)


def run_chain(name: str, *args):
    return ptx_run_chain(CHAINS, name, *args)


# -----------------------------------------------------------------------------
# The sources' structure
# -----------------------------------------------------------------------------

def _header_words(fn: str) -> int:
    text = HEADER[HEADER.index(f"{fn}(int i)"):][:400]
    return lf.limbs_to_int(np.array(
        [int(v, 16) for v in re.findall(r"0x[0-9a-f]{8}", text)[:N]],
        dtype=np.uint32))


def test_header_chains_are_all_parsed():
    assert sorted(CHAINS) == ["add8", "add8_carry", "mad4_carry", "merge9",
                              "shift_mad4", "sub8", "sub9"]
    check_operands_all_used(CHAINS)
    # the constants the model takes from Python are the header's
    assert _header_words("r2") == 2 * P
    assert _header_words("one") == R % P == FR.R
    assert "Fr::NP0" in HEADER and NP0 == FR.nprime


def test_sources_are_what_the_model_transcribes():
    """The C++ around the asm that the model below copies by hand."""
    dot_body = function_body(HEADER, "dot")
    assert "uint32_t* e = (i & 1) ? od : ev;" in dot_body
    assert "uint32_t* o = (i & 1) ? ev : od;" in dot_body
    assert "re[k] = Fr::p(2 * k);" in dot_body
    assert "ro[k] = Fr::p(2 * k + 1);" in dot_body
    assert "const uint32_t xe[4] = {x[0], x[2], x[4], x[6]};" in dot_body
    assert "const uint32_t xo[4] = {x[1], x[3], x[5], x[7]};" in dot_body
    assert "const uint32_t* x = a(j);" in dot_body
    assert "const uint32_t wj = w(j, i);" in dot_body
    assert "const uint32_t m = e[0] * Fr::NP0;" in dot_body
    assert "if (i == 0 && j == 0) {" in dot_body
    assert "if (j >= KW && i > 0) continue;" in dot_body
    assert "template <int K, int KW = K, class A, class W>" in HEADER
    assert "} else if (j == 0) {" in dot_body
    steps = re.findall(r"\b(shift_mad4|mad4_carry|merge9)\(([^;]*)\);|"
                       r"\b([eo]\[N\] = 0);", dot_body)
    assert [s[0] + s[1] + s[2] for s in steps] == [
        "e[N] = 0", "o[N] = 0",
        "shift_mad4e[0], o, xo, wj", "o[N] = 0", "mad4_carrye, e[N], xe, wj",
        "mad4_carryo, o[N], xo, wj", "mad4_carrye, e[N], xe, wj",
        "mad4_carryo, o[N], ro, m", "mad4_carrye, e[N], re, m",
        "merge9ev, od"]
    assert "for (int i = 0; i <= N; ++i) t[i] = ev[i];" in dot_body

    mul_body = function_body(HEADER, "mul")
    assert ("dot<1>(t, [&](int) { return a; }, [&](int, int i) "
            "{ return b[i]; });") in mul_body
    sbox_body = function_body(HEADER, "sbox")
    assert re.findall(r"\b(mul|reduce_r)\(([^;]*)\);", sbox_body) == [
        ("mul", "x2, x, x"), ("reduce_r", "x2"), ("mul", "x4, x2, x2"),
        ("mul", "x, x, x4"), ("reduce_r", "x")]
    red = function_body(HEADER, "reduce_dot")
    assert "k[i] = r2(i);" in red
    assert "const uint32_t borrow = sub9(d, k);" in red
    assert "r[i] = borrow ? t[i] : d[i];" in red
    assert calls(red, "reduce_r") == ["r"]
    red = function_body(HEADER, "reduce_r")
    assert "k[i] = Fr::p(i);" in red
    assert "const uint32_t borrow = sub8(d, k);" in red
    assert "x[i] = borrow ? x[i] : d[i];" in red
    add = function_body(HEADER, "add_r")
    assert calls(add, "add8") == ["x, c"] and calls(add, "reduce_r") == ["x"]

    # the one-thread kernel: the state's words are the multiplicands
    one = HADES[HADES.index("hades_kernel("):HADES.index("hades_coop_kernel(")]
    assert "zk::frl::add_r(s[w], k);" in one
    assert "k[j] = arc[w * kLimbs + j];" in one
    assert "for (int w = 0; w < kWidth - 1; ++w) zk::frl::sbox(s[w]);" in one
    assert "zk::frl::sbox(s[kWidth - 1]);" in one
    assert "const uint32_t* m = mds + row * kWidth * kLimbs;" in one
    assert "acc, [&](int col) { return s[col]; }," in one
    assert "[&](int col, int i) { return m[col * kLimbs + i]; });" in one
    assert "zk::frl::reduce_dot(o[row], acc);" in one
    # the five-thread kernel: the matrix row is the multiplicand, the state
    # words come by shuffle from the lane that holds them
    coop = HADES[HADES.index("hades_coop_kernel("):]
    assert ("mrow[col][j] = consts[kArcWords + ((word * kWidth) + col) * "
            "kLimbs + j];") in coop
    assert "zk::frl::add_r(s, arc);" in coop
    assert "arc[j] = consts[(next * kWidth + word) * kLimbs + j];" in coop
    assert "zk::frl::sbox(x);" in coop
    assert "boxed = full_round(r) || word == kWidth - 1;" in coop
    assert "s[j] = boxed ? x[j] : s[j];" in coop
    assert "acc, [&](int col) { return mrow[col]; }," in coop
    assert "return __shfl_sync(0xffffffffu, s[i], first + col);" in coop
    assert "zk::frl::reduce_dot(s, acc);" in coop
    assert "return r < kHalfFull || r >= kHalfFull + kPartial;" in HADES

    # one bit of the Fr power chain
    fr_chain = MONT[MONT.index("struct Chain<zk::Fr>"):
                    MONT.index("mont_pow_kernel(")]
    assert re.findall(r"zk::frl::(mul|reduce_r)\(([^;]*)\);", fr_chain) == [
        ("mul", "acc, acc, acc"), ("mul", "acc, base, acc"),
        ("reduce_r", "acc")]
    assert "acc[i] = zk::frl::one(i);" in fr_chain
    assert "Chain<F>::step(acc, x, (e.w[i >> 5] >> (i & 31)) & 1u);" in MONT
    assert "for (int i = bits - 1; i >= 0; --i)" in MONT


# -----------------------------------------------------------------------------
# The header's functions, transcribed
# -----------------------------------------------------------------------------

def words(v: int, n: int = N) -> list[int]:
    assert 0 <= v < 1 << (32 * n)
    return [(v >> (32 * i)) & M32 for i in range(n)]


def value(w) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(w))


P_WORDS, P2_WORDS = words(P), words(2 * P)


def dot(a, w, kw=None):
    """`zk::frl::dot<K, KW>`: `a` the K multiplicands (eight words each),
    `w(j, i)` word i of the operand scanned against multiplicand j; the
    operands j >= KW (`kw`, K by default) are one word, which row 0 alone
    takes.  Returns the nine words and asserts the header's ranges."""
    k_terms = len(a)
    kw = k_terms if kw is None else kw
    assert 1 <= kw <= k_terms <= 5
    re_, ro = P_WORDS[0::2], P_WORDS[1::2]
    ev, od = [0] * (N + 1), [0] * (N + 1)
    bound = sum(value(x) for x in a) + P  # of the running value
    scanned = [[w(j, i) for i in range(N)] for j in range(k_terms)]
    for i in range(N):
        e, o = (od, ev) if i & 1 else (ev, od)
        for j in range(k_terms):
            if j >= kw and i > 0:
                assert scanned[j][i] == 0  # a one-word operand
                continue
            x = a[j]
            xe, xo = x[0::2], x[1::2]
            wj = scanned[j][i]
            if i == 0 and j == 0:
                for k in range(4):
                    pe, po = xe[k] * wj, xo[k] * wj
                    e[2 * k], e[2 * k + 1] = pe & M32, pe >> 32
                    o[2 * k], o[2 * k + 1] = po & M32, po >> 32
                e[N] = o[N] = 0
            elif j == 0:
                assert o[0] == 0  # last row's reduction cleared it
                scalars, wrapped = run_chain("shift_mad4", e[0], o, xo, wj)
                assert not wrapped
                e[0] = scalars["ev0"]
                o[N] = 0
                scalars, wrapped = run_chain("mad4_carry", e, e[N], xe, wj)
                assert not wrapped
                e[N] = scalars["top"]
            else:
                for arr, half in ((o, xo), (e, xe)):
                    scalars, wrapped = run_chain("mad4_carry", arr, arr[N],
                                                 half, wj)
                    assert not wrapped
                    arr[N] = scalars["top"]
        m = (e[0] * NP0) & M32
        for arr, half in ((o, ro), (e, re_)):
            scalars, wrapped = run_chain("mad4_carry", arr, arr[N], half, m)
            assert not wrapped  # no carry leaves the ninth word
            arr[N] = scalars["top"]
        assert e[0] == 0
        # the running value after the division by 2^32
        assert value(e[1:]) + value(o) < bound
    _, wrapped = run_chain("merge9", ev, od)
    assert not wrapped
    total = sum(value(x) * value(s) for x, s in zip(a, scanned))
    assert value(ev) * R < total + P * R  # t < sum a b / R + r
    assert value(ev) % P == total * RINV % P
    return ev


def mul(a, b):
    """`zk::frl::mul`: eight words, needs a + r <= 2^256."""
    assert value(a) + P <= R
    t = dot([a], lambda j, i: b[i])
    assert t[N] == 0
    return t[:N]


def reduce_r(x):
    assert value(x) < 2 * P
    d = list(x)
    scalars, _ = run_chain("sub8", d, P_WORDS)
    assert scalars["mask"] in (0, M32)
    if not scalars["mask"]:
        x[:] = d
    assert value(x) < P


def add_r(x, c):
    assert value(x) < P and value(c) < P
    _, wrapped = run_chain("add8", x, c)
    assert not wrapped  # 2r < 2^256
    reduce_r(x)


def reduce_dot(t):
    assert len(t) == N + 1 and value(t) < 4 * P
    d = list(t)
    scalars, _ = run_chain("sub9", d, P2_WORDS)
    assert scalars["mask"] in (0, M32)
    r = list(t[:N]) if scalars["mask"] else d[:N]
    if not scalars["mask"]:
        assert d[N] == 0
    else:
        assert t[N] == 0
    reduce_r(r)
    return r


def sbox(x):
    v = value(x)
    x2 = mul(x, x)
    assert value(x2) * 1000 < 1453 * P
    reduce_r(x2)
    x4 = mul(x2, x2)
    assert value(x4) * 1000 < 1453 * P
    x5 = mul(x, x4)
    assert value(x5) * 1000 < 1658 * P
    reduce_r(x5)
    assert value(x5) == pow(v, 5, P) * pow(RINV, 4, P) % P
    x[:] = x5


CONSTS = lf.tensor_to_u32(poseidon.hades_consts(torch.device("cpu")))
ARC = [[[int(v) for v in CONSTS[(r * 5 + w)]] for w in range(5)]
       for r in range(68)]
MDS = [[[int(v) for v in CONSTS[340 + row * 5 + col]] for col in range(5)]
       for row in range(5)]


def round_one_thread(s, r):
    """One round of `hades_kernel` on the five words of one lane."""
    for w in range(5):
        add_r(s[w], ARC[r][w])
    if kernels.hades_full_round(r):
        for w in range(4):
            sbox(s[w])
    sbox(s[4])
    out = []
    for row in range(5):
        acc = dot([s[col] for col in range(5)],
                  lambda col, i, row=row: MDS[row][col][i])
        assert value(acc) * 100 < 327 * P
        out.append(reduce_dot(acc))
    return out


def round_five_threads(s, r):
    """One round of `hades_coop_kernel`: thread `word` holds s[word]; every
    per-thread statement runs for all five, a shuffle reads another
    thread's registers as they are before the round's dot product."""
    for word in range(5):
        add_r(s[word], ARC[r][word])
        x = list(s[word])
        sbox(x)  # every thread raises its word
        if kernels.hades_full_round(r) or word == 4:
            s[word] = x
    out = []
    for word in range(5):
        acc = dot([MDS[word][col] for col in range(5)],
                  lambda col, i: s[col][i])  # __shfl_sync(s[i], first + col)
        assert value(acc) * 100 < 327 * P
        out.append(reduce_dot(acc))
    return out


def _rand_below(rng, bound: int) -> int:
    return int.from_bytes(rng.bytes(40), "little") % bound


# -----------------------------------------------------------------------------
# (a) the product and the dot product, their ranges on worst-case operands
# -----------------------------------------------------------------------------

# the largest multiplicand `mul` takes: a + r = 2^256
A_MAX = R - P
EDGE_A = {"0": 0, "1": 1, "r-1": P - 1, "R_mod_r": R % P, "2^256-r": A_MAX}
EDGE_B = {**EDGE_A, "1.453r": 1453 * P // 1000, "2r-1": 2 * P - 1,
          "2^256-1": R - 1}


@pytest.mark.parametrize("a", sorted(EDGE_A))
@pytest.mark.parametrize("b", sorted(EDGE_B))
def test_mul_schedule_on_edge_operands(a, b):
    va, vb = EDGE_A[a], EDGE_B[b]
    got = value(mul(words(va), words(vb)))
    assert got % P == va * vb * RINV % P
    # the exact (unreduced) Montgomery quotient
    assert got * R == va * vb + (va * vb * (-pow(P, -1, R)) % R) * P


def test_mul_on_seeded_operands_keeps_the_stated_bounds():
    rng = np.random.default_rng(31)
    for bound_a, bound_b, limit in ((P, P, 1453), (P, 1453 * P // 1000, 1658),
                                    (A_MAX + 1, R, None)):
        for _ in range(6):
            a, b = _rand_below(rng, bound_a), _rand_below(rng, bound_b)
            got = value(mul(words(a), words(b)))
            assert got % P == a * b * RINV % P
            if limit:
                assert got * 1000 < limit * P


def test_mul_refuses_a_multiplicand_the_proof_does_not_cover():
    with pytest.raises(AssertionError):
        mul(words(A_MAX + 1), words(5))


def test_a_square_at_1_64_r_would_not_fit_eight_words():
    """Why x^2 is reduced before it is squared again: the running value of a
    multiplicand above 2^256 - r can pass 2^256."""
    a = 164 * P // 100
    assert a + P > R
    t = dot([words(a)], lambda j, i: words(R - 1)[i])
    assert t[N] == 1  # the ninth word is in use


@pytest.mark.parametrize("case", ["all_r-1", "zero", "mds_row", "mixed",
                                  "seeded"])
def test_dot_of_five_keeps_its_ranges(case):
    rng = np.random.default_rng(32)
    top = words(P - 1)
    if case == "all_r-1":
        a, b = [top] * 5, [top] * 5
    elif case == "zero":
        a, b = [words(0)] * 5, [top] * 5
    elif case == "mds_row":   # the constants against the largest state
        a, b = MDS[4], [top] * 5
    elif case == "mixed":
        a = [top, words(0), words(1), top, words(R % P)]
        b = [words(1), top, top, words(R % P), words(0)]
    else:
        a = [words(_rand_below(rng, P)) for _ in range(5)]
        b = [words(_rand_below(rng, P)) for _ in range(5)]
    acc = dot(a, lambda j, i: b[j][i])
    assert value(acc) * 100 < 327 * P and acc[N] <= 1
    want = sum(value(x) * value(y) for x, y in zip(a, b)) * RINV % P
    assert value(reduce_dot(acc)) == want
    # the scanned operands may be any eight words
    acc = dot(a, lambda j, i: M32)
    assert value(acc) < 6 * P and acc[N] <= 2


def test_reductions_at_their_edges():
    for v in (0, P - 1, P, 2 * P - 1):
        x = words(v)
        reduce_r(x)
        assert value(x) == v % P
    for v in (0, P - 1, P, 2 * P - 1, 2 * P, 3 * P, 327 * P // 100, R - 1, R,
              4 * P - 1):
        assert value(reduce_dot(words(v, N + 1))) == v % P
    for a, c in ((P - 1, P - 1), (0, 0), (P - 1, 1), (1, P - 2)):
        x = words(a)
        add_r(x, words(c))
        assert value(x) == (a + c) % P
    with pytest.raises(AssertionError):
        reduce_r(words(2 * P))


def test_round_constant_extremes():
    """The largest and the smallest round constant and matrix entry against
    the largest state word."""
    flat = [c for rnd in ARC for c in rnd]
    big, small = max(flat, key=value), min(flat, key=value)
    assert value(big) < P
    for c in (big, small):
        x = words(P - 1)
        add_r(x, c)
        sbox(x)
    biggest_row = max(MDS, key=lambda row: sum(value(m) for m in row))
    acc = dot(biggest_row, lambda j, i: M32)
    assert value(acc) < sum(value(m) for m in biggest_row) + P


# -----------------------------------------------------------------------------
# (b) S-box and rounds
# -----------------------------------------------------------------------------

def test_sbox_on_edge_values():
    for v in (0, 1, P - 1, R % P, (P + 1) // 2):
        x = words(v)
        sbox(x)  # asserts x^5 and every range on the way


def test_one_cooperative_round_equals_one_thread(monkeypatch):
    """A full and a partial round, worst-case state first."""
    rng = np.random.default_rng(33)
    for state in ([P - 1] * 5, [0] * 5,
                  [_rand_below(rng, P) for _ in range(5)]):
        for r in (0, 4, 63, 67):
            one = round_one_thread([words(v) for v in state], r)
            five = round_five_threads([words(v) for v in state], r)
            assert one == five
            assert all(value(w) < P for w in one)


# -----------------------------------------------------------------------------
# (c) the whole permutation, tolerance zero
# -----------------------------------------------------------------------------

def _permute(state, one_round):
    s = [words(v) for v in state]
    for r in range(68):
        s = one_round(s, r)
    return [value(w) for w in s]


@pytest.fixture(scope="module")
def lanes():
    """Montgomery states of three lanes: every word r - 1, zero, seeded."""
    rng = np.random.default_rng(34)
    return [[P - 1] * 5, [0] * 5, [_rand_below(rng, P) for _ in range(5)]]


@pytest.fixture(scope="module")
def plain(lanes):
    arr = np.stack([np.stack([lf.int_to_limbs(v, N) for v in lane])
                    for lane in lanes], axis=-1)  # [5, 8, lanes]
    out = kernels.hades_permute_plain(
        lf.u32_to_tensor(arr, "cpu"), poseidon.hades_consts(
            torch.device("cpu")))
    host = lf.tensor_to_u32(out)
    return [[lf.limbs_to_int(host[w, :, j]) for w in range(5)]
            for j in range(len(lanes))]


@pytest.mark.parametrize("lane,kernel", [(0, "one_thread"), (1, "one_thread"),
                                         (2, "one_thread"),
                                         (2, "five_threads")])
def test_full_permutation_ends_on_plain_version_and_host(lanes, plain, lane,
                                                         kernel):
    one_round = (round_one_thread if kernel == "one_thread"
                 else round_five_threads)
    got = _permute(lanes[lane], one_round)
    assert got == plain[lane]
    # the reference's host permutation works on canonical values
    canon = [v * RINV % P for v in lanes[lane]]
    assert [v * RINV % P for v in got] == ref_hades_permute(canon)


# -----------------------------------------------------------------------------
# (d) one bit of the Fr power chain
# -----------------------------------------------------------------------------

def _pow_chain(base: int, e: int) -> int:
    """`Chain<zk::Fr>` of mont_mul.cu walked by `mont_pow_kernel`."""
    x = words(base)
    acc = words(R % P)
    for i in range(e.bit_length() - 1, -1, -1):
        acc = mul(acc, acc)
        assert value(acc) * 1000 < 1453 * P
        if (e >> i) & 1:
            acc = mul(x, acc)
            assert value(acc) * 1000 < 1658 * P
        reduce_r(acc)
    return value(acc)


@pytest.mark.parametrize("e", [0, 1, 2, 5, 0b1011011])
def test_power_chain_equals_plain_version(e):
    vals = [0, 1, P - 1, R % P, 0x1234567 << 200]
    arr = np.stack([lf.int_to_limbs(v, N) for v in vals], axis=-1)
    want = lf.tensor_to_u32(kernels.mont_pow_plain(
        FR, lf.u32_to_tensor(arr, "cpu"), e))
    for j, v in enumerate(vals):
        assert _pow_chain(v, e) == lf.limbs_to_int(want[:, j])
