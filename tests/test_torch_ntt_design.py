"""What the `ntt_stages` kernel (`zkvm_tpu_torch/csrc/ntt.cu`) assumes,
checked on the CPU.

The CUDA source cannot run here, so its schedule is transcribed line by
line: the passes of `kernels.ntt_plan` (the very function the wrapper
launches by), the blocks of each pass, which elements a block loads and
where it puts them in its tile -- the bit reversal folded into the first
pass's load --, the stages it runs between barriers (four rows and two
stages a thread, an odd last stage alone), the twiddle index of every
butterfly and where it stores the tile.  The model asserts that every pass
loads and stores each position exactly once, that the first pass reads runs
of C adjacent words, that no two threads of a step touch the same element,
and the range of every value.  Its butterfly is the kernel's arithmetic:
the carry chains of `csrc/fr_lazy.cuh` executed word by word
(`tests/ptx_model.py`, through `test_torch_hades_design.py`'s
transcription of `mul`, `reduce_r` and `add_r`) on small transforms, and
the same values in Python integers (the exact Montgomery quotient that
`mul` returns, which `test_torch_hades_design.py` holds against the chains)
on the larger ones.

What this file can and cannot see: the index expressions and the order of
the butterflies are pinned by `test_kernel_source_is_what_the_model_
transcribes`, so an edit there fails here until the model is brought up to
date; the launch (threads, shared memory) is not modelled.  The gate for
the kernel itself is the bit-for-bit comparison on the card
(`tests/test_torch_kernels_gpu.py`, `chip_smoke.py`).

The model is run at n = 2^1 .. 2^12, batch 1 and 3, forward and inverse,
over the kernel's own tiles and over tiles of 2^5 and 2^6 (so that small
transforms take two, three and more passes), and equals
`kernels.ntt_stages_plain`, the matmul route (`ntt_mxu.MXUTransform`) and
`zkvm_tpu`'s staged transform and `Domain.fft_device`, bit for bit.
"""

import functools
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx_model import calls, function_body
from test_torch_hades_design import (add_r, dot, mul, reduce_dot, reduce_r,
                                     run_chain)
from test_torch_hades_design import value as words_value
from test_torch_hades_design import words
from zkvm_tpu.ops import ntt as rntt
from zkvm_tpu_torch.ops import kernels, ntt, ntt_mxu
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FR

torch.set_num_threads(1)

P = FR.modulus
R = 1 << 256
M32 = 0xFFFFFFFF
NP_FULL = (-pow(P, -1, R)) % R
SOURCE = (Path(kernels.CSRC) / "ntt.cu").read_text()
FOLD = (Path(kernels.CSRC) / "ntt_fold.cu").read_text()
HEADER = (Path(kernels.CSRC) / "fr_lazy.cuh").read_text()
P_WORDS = words(P)


# -----------------------------------------------------------------------------
# The source's structure
# -----------------------------------------------------------------------------

def test_kernel_source_is_what_the_model_transcribes():
    """The C++ the model below copies by hand."""
    bf = function_body(SOURCE, "butterfly")
    assert re.findall(r"zk::frl::(\w+)\(([^;]*)\);", bf) == [
        ("mul", "y, w, y"), ("reduce_r", "y")]
    assert calls(bf, "butterfly_one") == ["x, y"]
    one = function_body(SOURCE, "butterfly_one")
    assert re.findall(r"zk::frl::(\w+)\(([^;]*)\);", one) == [
        ("sub_r", "d, y"), ("add_carry_r", "x, y")]
    assert "for (int i = 0; i < N; ++i) d[i] = x[i];" in one
    assert "for (int i = 0; i < N; ++i) y[i] = d[i];" in one
    unit = function_body(SOURCE, "butterfly_unit")
    assert re.findall(r"(?:zk::frl::)?(\w+)\(([^;]*)\);", unit) == [
        ("reduce_words", "y"), ("butterfly_one", "x, y")]
    sub = function_body(HEADER, "sub_r")
    assert "const uint32_t borrow = sub8(x, c);" in sub
    assert "for (int i = 0; i < N; ++i) k[i] = Fr::p(i) & borrow;" in sub
    assert calls(sub, "add8") == ["x, k"]
    add = " ".join(function_body(HEADER, "add_carry_r").split())
    assert "const uint32_t carry = add8_carry(x, c);" in add
    assert "k[i] = Fr::p(i); d[i] = x[i];" in add
    assert "d[N] = carry;" in add
    assert "const uint32_t borrow = sub9(d, k);" in add
    assert "x[i] = borrow ? x[i] : d[i];" in add
    red = " ".join(function_body(HEADER, "reduce_words").split())
    assert "for (int pass = 0; pass < 2; ++pass) {" in red
    assert "for (int i = 0; i < N; ++i) k[i] = Fr::p(i);" in red
    assert "for (int i = 0; i < N; ++i) d[i] = x[i];" in red
    assert "const uint32_t borrow = sub8(d, k);" in red
    assert "x[i] = borrow ? x[i] : d[i];" in red
    kernel = SOURCE[SOURCE.index("ntt_pass_kernel("):
                    SOURCE.index('extern "C"')]
    for line in (
            "const int E = 1 << (k + c);",
            "const int C = 1 << c;",
            "const long long g = blockIdx.x / per_row;",
            "const long long f = blockIdx.x - g * per_row;",
            "const uint32_t* src = s0 == 0 ? in + g * N * n : out + g * N * n;",
            "const long long lo = s0 == 0 ? 0 : f & ((1ll << (s0 - c)) - 1);",
            "const long long hi = s0 == 0 ? 0 : f >> (s0 - c);",
            "const long long base = (hi << (s0 + k)) | (lo << c);",
            # the first pass's load
            "const long long fb = brev(f, log_n - k - c) << c;",
            "const int xr = i >> c, xc = i & (C - 1);",
            "const long long xi = ((long long)xr << (log_n - k)) | fb | xc;",
            "const int e = (int)((brev(xr, k) << c) | brev(xc, c));",
            "for (int l = 0; l < N; ++l) tile[l * E + e] = src[l * n + xi];",
            # a later pass's load and store
            "const long long p = base | ((long long)(i >> c) << s0) | "
            "(i & (C - 1));",
            "for (int l = 0; l < N; ++l) tile[l * E + i] = src[l * n + p];",
            "for (int l = 0; l < N; ++l) dst[l * n + p] = tile[l * E + i];",
            # the stages
            "const long long low = s0 == 0 ? 0 : lo << c;",
            # the first pass's first stage pair, a step of its own
            "int j0 = 0;",
            "if (s0 == 0 && k >= 2) {",
            "const long long wi = 1ll << (log_n - 2);",
            "const int a = (v << (c + 2)) | col;",
            "x[m][l] = tile[l * E + a + m * C];",
            "tile[l * E + a + m * C] = x[m][l];",
            "j0 = 2;",
            "for (int j = j0; j < k; j += 2) {",
            "const int s = s0 + j;",
            "const int below = (1 << j) - 1;",
            "if (j + 1 < k) {",
            "for (int q = threadIdx.x; q < E / 4; q += blockDim.x) {",
            "const int col = q & (C - 1), v = q >> c;",
            "const int a = ((((v >> j) << (j + 2)) | (v & below)) << c) | col;",
            "const int step = C << j;",
            "((long long)(v & below) << s0) | (s0 == 0 ? 0 : low | col);",
            "const long long wi[3] = {t << (log_n - 1 - s), t << (log_n - 2 - s),",
            "(t | (1ll << s)) << (log_n - 2 - s)};",
            "w[m][l] = __ldg(tw + l * half + wi[m]);",
            "x[m][l] = tile[l * E + a + m * step];",
            "tile[l * E + a + m * step] = x[m][l];",
            "for (int q = threadIdx.x; q < E / 2; q += blockDim.x) {",
            "const int col = q & (C - 1), u = q >> c;",
            "const int a = ((((u >> j) << (j + 1)) | (u & below)) << c) | col;",
            "const int b = a + (C << j);",
            "((long long)(u & below) << s0) | (s0 == 0 ? 0 : low | col);",
            "const long long wi = t << (log_n - 1 - s);",
            "w[l] = __ldg(tw + l * half + wi);",
            # the first pass's store
            "const int row = i & (K - 1), col = i >> k;",
            "const long long p = ((long long)col << (log_n - c)) | (f << k) | "
            "row;",
            "dst[l * n + p] = tile[l * E + (row << c) + col];"):
        assert line in " ".join(kernel.split()), line
    # the first stage pair: three butterflies whose twiddle is tw[0] = 1
    assert re.findall(r"butterfly_unit\(([^;]*)\);", kernel) == [
        "x[0], x[1]", "x[2], x[3]", "x[0], x[2]"]
    assert "butterfly_one(" not in kernel
    assert re.findall(r"butterfly\(([^;]*)\);", kernel) == [
        "x[1], x[3], w", "x[0], x[1], w[0]", "x[2], x[3], w[0]",
        "x[0], x[2], w[1]", "x[1], x[3], w[2]", "x, y, w"]
    assert kernel.count("__syncthreads();") == 3
    entry = SOURCE[SOURCE.index('extern "C"'):]
    assert ("const long long per_row = 1ll << (log_n - k - c);"
            in entry)
    assert "(unsigned)(rows * per_row)" in entry
    # the wrapper launches the passes of the plan the model walks
    assert ("for s0, k, c in ntt_plan(log_n, ntt_log_tile(log_n)):"
            in inspect.getsource(kernels.ntt_stages))


# -----------------------------------------------------------------------------
# The butterfly: the chains executed, and the same values in integers
# -----------------------------------------------------------------------------

def sub_r(x, c, canonical=True):
    """`zk::frl::sub_r`, transcribed; c canonical, x canonical unless
    `canonical` is false (any eight words: the reference's sub, x - c where
    x >= c, else x - c + r)."""
    want = words_value(x) - words_value(c)
    assert words_value(c) < P and (words_value(x) < P or not canonical)
    scalars, _ = run_chain("sub8", x, c)
    borrow = scalars["mask"]
    assert borrow in (0, M32)
    _, wrapped = run_chain("add8", x, [k & borrow for k in P_WORDS])
    assert wrapped == bool(borrow)  # the carry out cancels the borrow
    assert words_value(x) == (want + P if want < 0 else want)


def add_carry_r(x, c):
    """`zk::frl::add_carry_r`, transcribed: x any eight words, c canonical;
    the reference's add, x + c less r where that is r or more."""
    want = words_value(x) + words_value(c)
    assert words_value(c) < P
    scalars, _ = run_chain("add8_carry", x, c)
    carry = scalars["carry"]
    assert carry == want >> 256
    d = list(x) + [carry]
    scalars, _ = run_chain("sub9", d, P_WORDS)
    assert scalars["mask"] in (0, M32)
    if not scalars["mask"]:
        assert d[8] == 0  # the difference fits eight words
        x[:] = d[:8]
    assert words_value(x) == (want - P if want >= P else want)


def reduce_words(x):
    """`zk::frl::reduce_words`, transcribed: any eight words, canonical."""
    v = words_value(x)
    for _ in range(2):
        d = list(x)
        scalars, _ = run_chain("sub8", d, P_WORDS)
        assert scalars["mask"] in (0, M32)
        if not scalars["mask"]:
            x[:] = d
    assert words_value(x) == v % P


def butterfly_ptx(x: int, y: int, w: int | None,
                  canonical: bool = True) -> tuple[int, int]:
    """`butterfly` of ntt.cu on the header's chains; `butterfly_unit` where
    w is None (the twiddle 1, no product).  x and y canonical, unless
    `canonical` is false: any 256-bit words."""
    assert (x < P and y < P) or not canonical
    assert w is None or w < P
    t = words(y)
    if w is None:
        reduce_words(t)                  # what the product by R mod r gives
    else:
        t = mul(words(w), t)             # the twiddle is the multiplicand
        assert words_value(t) * 1000 < 1453 * P or not canonical
        assert words_value(t) < 2 * P    # any y: below w y / R + r
        reduce_r(t)
    d = words(x)
    sub_r(d, t, canonical)
    xs = words(x)
    add_carry_r(xs, t)
    if canonical:
        assert words_value(xs) < P and words_value(d) < P
    return words_value(xs), words_value(d)


def butterfly_int(x: int, y: int, w: int | None,
                  canonical: bool = True) -> tuple[int, int]:
    """The same values in integers: `mul` returns the exact Montgomery
    quotient (w y + m r) / R, below 1.453 r for canonical operands (2 r for
    any y); w None is `butterfly_unit`'s twiddle 1, y mod r.  The sum less
    r where it is r or more, the difference plus r where it is negative."""
    assert (x < P and y < P) or not canonical
    assert w is None or w < P
    if w is None:
        t = y % P
    else:
        prod = w * y
        t = (prod + (prod * NP_FULL % R) * P) // R
        assert t * 1000 < 1453 * P or not canonical
        assert t < 2 * P
        if t >= P:
            t -= P
    plus = x + t - P if x + t >= P else x + t
    return plus, x - t if x >= t else x - t + P


EDGE = [0, 1, P - 1, R % P, (P + 1) // 2]


@pytest.mark.parametrize("w", EDGE + [0x1234567 << 200, None])
def test_butterfly_chains_on_edge_operands(w):
    for x in EDGE:
        for y in EDGE:
            assert butterfly_ptx(x, y, w) == butterfly_int(x, y, w)


def test_sub_r_at_its_edges():
    for a, c in ((0, 0), (0, P - 1), (P - 1, 0), (5, 7), (P - 1, P - 1)):
        x = words(a)
        sub_r(x, words(c))
        assert words_value(x) == (a - c) % P
    # on any eight words x it is the reference's sub (`limb_field.sub`)
    for a, c in ((P, 0), (P, P - 1), (R - 1, 0), (R - 1, P - 1),
                 (P + 1, P - 1), (2 * P, 1)):
        x = words(a)
        sub_r(x, words(c), canonical=False)


def test_add_carry_r_and_reduce_words_at_their_edges():
    """The carry-keeping add on sums across 2^256, and the two conditional
    subtractions on words up to 2^256 - 1; on canonical operands the add is
    `add_r`."""
    for a, c in ((R - 1, P - 1), (R - 1, 0), (R - P, P - 1), (R - P - 1, 1),
                 (P, 0), (2 * P, P - 1), (0, 0), (P - 1, P - 1), (P - 1, 1)):
        x = words(a)
        add_carry_r(x, words(c))
        if a < P:
            y = words(a)
            add_r(y, words(c))
            assert y == x
    for v in (0, P - 1, P, 2 * P - 1, 2 * P, R - 1, R % P):
        reduce_words(words(v))


# -----------------------------------------------------------------------------
# The schedule
# -----------------------------------------------------------------------------

def brev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def model(rows: list[list[int]], tw: list[int], log_tile: int,
          butterfly=butterfly_int, canonical=True) -> list[list[int]]:
    """`zk_ntt_pass` over the passes of `kernels.ntt_plan(L, log_tile)` on
    canonical Montgomery values (any 256-bit words where `canonical` is
    false, whose outputs are then not asserted below r); `tw` the twiddle
    table (n/2 values)."""
    n = len(rows[0])
    log_n = n.bit_length() - 1
    half = n >> 1
    assert len(tw) == max(half, 1)
    assert tw[0] == R % P  # the twiddle of t = 0 is 1, Montgomery form
    out = [[None] * n for _ in rows]
    for s0, k, c in kernels.ntt_plan(log_n, log_tile):
        E, C, K = 1 << (k + c), 1 << c, 1 << k
        assert k + c <= log_tile and (s0 == 0 or c <= s0)
        per_row = 1 << (log_n - k - c)
        for g in range(len(rows)):
            src = rows[g] if s0 == 0 else out[g]
            loaded, stored = set(), set()
            for f in range(per_row):
                lo = 0 if s0 == 0 else f & ((1 << (s0 - c)) - 1)
                hi = 0 if s0 == 0 else f >> (s0 - c)
                base = (hi << (s0 + k)) | (lo << c)
                tile = [None] * E
                if s0 == 0:
                    fb = brev(f, log_n - k - c) << c
                    for i in range(E):
                        xr, xc = i >> c, i & (C - 1)
                        xi = (xr << (log_n - k)) | fb | xc
                        e = (brev(xr, k) << c) | brev(xc, c)
                        assert tile[e] is None and xi not in loaded
                        # element (row, col) holds position p of the
                        # bit-reversed order: input brev_L(p)
                        p = (brev(xc, c) << (log_n - c)) | (f << k) | brev(
                            xr, k)
                        assert xi == brev(p, log_n)
                        tile[e] = src[xi]
                        loaded.add(xi)
                    # the C columns of an input row are C adjacent words
                    for xr in range(K):
                        first = (xr << (log_n - k)) | fb
                        assert {first + xc for xc in range(C)} <= loaded
                else:
                    for i in range(E):
                        p = base | ((i >> c) << s0) | (i & (C - 1))
                        assert p not in loaded
                        tile[i] = src[p]
                        loaded.add(p)
                low = 0 if s0 == 0 else lo << c
                j = 0
                if s0 == 0 and k >= 2:
                    # stages 0 and 1: the general step's quads at j = 0,
                    # where t = 0: the first three butterflies take tw[0]
                    # = 1 and no product, the last tw[n/4]
                    wi = 1 << (log_n - 2)
                    touched = set()
                    for q in range(E // 4):
                        col, v = q & (C - 1), q >> c
                        a = (v << (c + 2)) | col
                        idx = [a + m * C for m in range(4)]
                        assert not touched & set(idx)
                        touched |= set(idx)
                        x = [tile[e] for e in idx]
                        x[0], x[1] = butterfly(x[0], x[1], None)
                        x[2], x[3] = butterfly(x[2], x[3], None)
                        x[0], x[2] = butterfly(x[0], x[2], None)
                        x[1], x[3] = butterfly(x[1], x[3], tw[wi])
                        for e, val in zip(idx, x):
                            tile[e] = val
                    assert len(touched) == E
                    j = 2
                while j < k:
                    s = s0 + j
                    below = (1 << j) - 1
                    touched = set()
                    if j + 1 < k:
                        for q in range(E // 4):
                            col, v = q & (C - 1), q >> c
                            a = ((((v >> j) << (j + 2)) | (v & below)) << c
                                 ) | col
                            step = C << j
                            t = (v & below) << s0 | (0 if s0 == 0
                                                     else low | col)
                            wi = [t << (log_n - 1 - s), t << (log_n - 2 - s),
                                  (t | (1 << s)) << (log_n - 2 - s)]
                            idx = [a + m * step for m in range(4)]
                            assert not touched & set(idx)
                            touched |= set(idx)
                            x = [tile[e] for e in idx]
                            x[0], x[1] = butterfly(x[0], x[1], tw[wi[0]])
                            x[2], x[3] = butterfly(x[2], x[3], tw[wi[0]])
                            x[0], x[2] = butterfly(x[0], x[2], tw[wi[1]])
                            x[1], x[3] = butterfly(x[1], x[3], tw[wi[2]])
                            for e, val in zip(idx, x):
                                tile[e] = val
                        j += 2
                    else:
                        for q in range(E // 2):
                            col, u = q & (C - 1), q >> c
                            a = ((((u >> j) << (j + 1)) | (u & below)) << c
                                 ) | col
                            b = a + (C << j)
                            t = (u & below) << s0 | (0 if s0 == 0
                                                     else low | col)
                            assert not touched & {a, b}
                            touched |= {a, b}
                            tile[a], tile[b] = butterfly(
                                tile[a], tile[b], tw[t << (log_n - 1 - s)])
                        j += 1
                    assert len(touched) == E  # every element, once a step
                if s0 == 0:
                    for i in range(E):
                        row, col = i & (K - 1), i >> k
                        p = (col << (log_n - c)) | (f << k) | row
                        assert p not in stored
                        out[g][p] = tile[(row << c) + col]
                        stored.add(p)
                else:
                    for i in range(E):
                        p = base | ((i >> c) << s0) | (i & (C - 1))
                        assert p not in stored
                        out[g][p] = tile[i]
                        stored.add(p)
            assert loaded == stored == set(range(n))
    assert all(v is not None and (0 <= v < P or not canonical)
               for row in out for v in row)
    return out


def test_plans_cover_every_stage_once():
    for log_tile in (4, 5, 6, 9, 10):
        for log_n in range(1, 25):
            plan = kernels.ntt_plan(log_n, log_tile)
            s0s = [s0 for s0, _, _ in plan]
            assert s0s == [sum(k for _, k, _ in plan[:i])
                           for i in range(len(plan))]
            assert sum(k for _, k, _ in plan) == log_n
            for i, (s0, k, c) in enumerate(plan):
                assert k >= 1 and c >= 0 and k + c <= log_tile
                assert c <= (log_n - k if i == 0 else s0)
    # the tiles the wrapper takes: two passes below 2^16, three up to 2^21
    assert [len(kernels.ntt_plan(L, kernels.ntt_log_tile(L)))
            for L in (9, 10, 11, 15, 16, 19, 20, 21)] == [1, 1, 2, 2, 3, 3,
                                                           3, 3]
    assert kernels.ntt_log_tile(19) == 9 and kernels.ntt_log_tile(20) == 10


def _values(count: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % P
            for _ in range(count)]
    vals[:len(EDGE)] = EDGE[:count]
    return vals


def _tensor(rows: list[list[int]]) -> torch.Tensor:
    """[batch, 8, n] int32 limbs of canonical (Montgomery) values."""
    arr = np.stack([np.stack([lf.int_to_limbs(v, 8) for v in row], axis=-1)
                    for row in rows])
    return lf.u32_to_tensor(arr, "cpu")


def _ints(t: torch.Tensor) -> list[list[int]]:
    host = lf.tensor_to_u32(t)
    return [[lf.limbs_to_int(host[g, :, i]) for i in range(host.shape[-1])]
            for g in range(host.shape[0])]


def _table(tw: torch.Tensor) -> list[int]:
    host = lf.tensor_to_u32(tw)
    return [lf.limbs_to_int(host[:, i]) for i in range(host.shape[-1])]


@pytest.mark.parametrize("log_n", range(1, 13))
@pytest.mark.parametrize("batch", [1, 3])
def test_schedule_equals_plain_matmul_route_and_reference(log_n, batch):
    n = 1 << log_n
    rows = [_values(n, 100 * log_n + g) for g in range(batch)]
    x = _tensor(rows)
    dom, rdom = ntt.Domain(n), rntt.Domain(n)
    tables = dom._butterfly_tables(torch.device("cpu"))
    brev_r, stages_r, fwd_r, inv_r = rdom._butterfly_tables()
    for inverse, tw in zip((False, True), tables):
        want = kernels.ntt_stages_plain(x, tw)
        root = dom.group_gen_inv if inverse else dom.group_gen
        assert torch.equal(want, ntt_mxu.MXUTransform(n, root)(x))
        want_ints = _ints(want)
        for log_tile in (kernels.ntt_log_tile(log_n), 5, 6):
            assert model(rows, _table(tw), log_tile) == want_ints, log_tile
        # zkvm_tpu's staged transform, one polynomial a call
        for g in range(batch):
            ref = rntt._ntt_impl_jnp(
                jnp.asarray(lf.to_reference(x[g], FR)), brev_r, *stages_r,
                inv_r if inverse else fwd_r)
            assert (lf.to_reference(want[g], FR) == np.asarray(ref)).all()
    if log_n in (3, 10):  # and its Domain's forward transform
        ref = rdom.fft_device(jnp.asarray(lf.to_reference(x[0], FR)))
        fwd = kernels.ntt_stages_plain(x, tables[0])
        assert (lf.to_reference(fwd[0], FR) == np.asarray(ref)).all()


@pytest.mark.parametrize("log_n,log_tile", [(2, 4), (5, 4), (6, 5)])
def test_schedule_on_the_chains_equals_plain(log_n, log_tile):
    """Small transforms over several passes with every butterfly executed
    on the header's carry chains."""
    n = 1 << log_n
    rows = [_values(n, 7 + log_n)]
    x = _tensor(rows)
    for tw in ntt.Domain(n)._butterfly_tables(torch.device("cpu")):
        assert len(kernels.ntt_plan(log_n, log_tile)) == {2: 1, 5: 4, 6: 3}[
            log_n]
        got = model(rows, _table(tw), log_tile, butterfly=butterfly_ptx)
        assert got == _ints(kernels.ntt_stages_plain(x, tw))


def above_r(rng, n: int) -> list[int]:
    """n values drawn from [r, 2^256), which no canonical element takes."""
    return [P + int.from_bytes(rng.bytes(40), "little") % (R - P)
            for _ in range(n)]


def _reference(x: torch.Tensor, n: int, inverse: bool) -> np.ndarray:
    """zkvm_tpu's staged transform of one row, in its layout."""
    brev_r, stages_r, fwd_r, inv_r = rntt.Domain(n)._butterfly_tables()
    return np.asarray(rntt._ntt_impl_jnp(
        jnp.asarray(lf.to_reference(x, FR)), brev_r, *stages_r,
        inv_r if inverse else fwd_r))


def test_outside_its_contract_the_kernel_differs_from_plain(monkeypatch):
    """Its name is from before the repair of `csrc/ntt.cu`, when the kernel
    differed from its plain version on input in [r, 2^256); the test now
    holds that it does not.  The first stage pair's butterflies by tw[0] =
    1 take no product: they used to add and subtract the odd operand as it
    came, where the plain version (like the reference) multiplies it by 1
    and so reduces it, and the kernel's add dropped the carry out of 2^256
    where the reference's keeps it.  On (0, 0, r + 1, 0), the smallest
    input that showed it, the schedule gave (1, 2^256 - 1 - r, 1, 2^256 -
    1) against the plain version's (1, r - 1, 1, r - 1).  Now
    `butterfly_unit` brings the odd operand below r and `add_carry_r` keeps
    the carry, and the schedule on the chains gives the plain version's
    words, which are `zkvm_tpu`'s `Domain.fft_device`'s (its staged route),
    on that row, (r, 0, 0, 0) (a non-canonical value passes a subtraction:
    (0, 0, 0, r)), (0, r + 1), rows of 2^256 - 1 and a mixed row."""
    monkeypatch.setenv("ZKVM_NTT_IMPL", "butterfly")
    cpu = torch.device("cpu")
    top = R - 1
    for row, plain in (
            ([0, 0, P + 1, 0], [1, P - 1, 1, P - 1]),
            ([P, 0, 0, 0], [0, 0, 0, P]),
            ([0, P + 1], [1, P - 1]),
            ([top] * 4, None), ([top] * 2, None),
            ([top, P, 2 * P, top - 1, 0, R % P, P - 1, P + 1], None)):
        n = len(row)
        x = _tensor([row])
        tw = ntt.Domain(n)._butterfly_tables(cpu)[0]
        want = _ints(kernels.ntt_stages_plain(x, tw))
        if plain is not None:
            assert want == [plain]
        log_tile = kernels.ntt_log_tile(n.bit_length() - 1)
        got = model([row], _table(tw), log_tile,
                    butterfly=functools.partial(butterfly_ptx,
                                                canonical=False),
                    canonical=False)
        assert got == want
        ref = rntt.Domain(n).fft_device(jnp.asarray(lf.to_reference(x[0],
                                                                    FR)))
        assert (lf.to_reference(kernels.ntt_stages_plain(x, tw)[0], FR)
                == np.asarray(ref)).all()


@pytest.mark.parametrize("log_n", [4, 9])
def test_schedule_on_words_in_r_to_2_256_equals_plain_and_reference(
        log_n, monkeypatch):
    """Seeded rows in [r, 2^256), forward and inverse, over the kernel's
    tiles and tiles of 2^5 (later passes then take non-canonical even
    operands): the schedule, on the chains at 2^4 and in integers at 2^9,
    equals the plain version and `zkvm_tpu`'s staged transform."""
    monkeypatch.setenv("ZKVM_NTT_IMPL", "butterfly")
    n = 1 << log_n
    rows = [above_r(np.random.default_rng(60 + log_n), n)]
    x = _tensor(rows)
    bf = butterfly_ptx if log_n == 4 else butterfly_int
    bf = functools.partial(bf, canonical=False)
    for inverse, tw in zip((False, True),
                           ntt.Domain(n)._butterfly_tables(
                               torch.device("cpu"))):
        want = kernels.ntt_stages_plain(x, tw)
        for log_tile in (kernels.ntt_log_tile(log_n), 5):
            assert model(rows, _table(tw), log_tile, butterfly=bf,
                         canonical=False) == _ints(want), log_tile
        assert (lf.to_reference(want[0], FR)
                == _reference(x[0], n, inverse)).all()
    ref = rntt.Domain(n).fft_device(jnp.asarray(lf.to_reference(x[0], FR)))
    assert (_reference(x[0], n, False) == np.asarray(ref)).all()


def test_wrapper_on_cpu_is_the_plain_version():
    n = 1 << 6
    x = _tensor([_values(n, 3), _values(n, 4)])
    before = kernels.LAUNCHES["ntt_stages"]
    for tw in ntt.Domain(n)._butterfly_tables(torch.device("cpu")):
        assert torch.equal(kernels.ntt_stages(x, tw),
                           kernels.ntt_stages_plain(x, tw))
    assert kernels.LAUNCHES["ntt_stages"] == before  # the CPU launches none


# -----------------------------------------------------------------------------
# fold and carry_fold: the split-fold of ntt_fold.cu
# -----------------------------------------------------------------------------

K1, K2 = (lf.limbs_to_int(k) for k in (kernels.K1, kernels.K2))


def test_fold_source_is_what_the_model_transcribes():
    body = " ".join(function_body(FOLD, "split_fold").split())
    for line in ("c1[i] = zk::Fr::k1(i);", "c2[i] = zk::Fr::k2(i);",
                 "lo[i] = v[i];",
                 "zk::frl::dot<2, 1>( t, [&](int j) { return j ? c2 : c1; }, "
                 "[&](int j, int i) { return j ? v[2 * N] : v[N + i]; });"):
        assert line in body, line
    assert re.findall(r"zk::frl::(reduce_dot|reduce_words|add_r)\(([^;]*)\);",
                      body) == [("reduce_dot", "r, t"), ("reduce_words", "lo"),
                                ("add_r", "r, lo")]
    for kernel in ("carry_fold_kernel(", "fold_kernel("):
        part = FOLD[FOLD.index(kernel):]
        assert calls(part[:part.index("\n}\n")], "split_fold") == ["r, v"]


def split_fold(v: int) -> int:
    """`split_fold` of ntt_fold.cu on the header's chains: the 17 words v =
    lo + 2^256 mid + 2^512 hi; dot<2, 1> with K1 and K2 as the
    multiplicands, mid and the one word hi scanned, reduced; lo mod r; their
    sum."""
    lo, mid, hi = words(v % R), words(v >> 256 & (R - 1)), words(v >> 512)
    t = dot([words(K1), words(K2)], lambda j, i: (hi if j else mid)[i], kw=1)
    assert words_value(t) < K1 + (1 << 31) + P < 2 * P
    r = reduce_dot(t)
    reduce_words(lo)
    add_r(r, lo)
    return words_value(r)


def test_fold_reduction_on_the_chains_equals_plain():
    """Edge words: lo, mid at 0, r - 1, r, 2^32 - 1, 2^256 - 1 (and 2r for
    lo), hi at 0, 1 and its largest, 2^32 - 1; and seeded words."""
    edges = (0, P - 1, P, (1 << 32) - 1, R - 1)
    vals = [lo + (mid << 256) + (hi << 512)
            for lo in edges + (2 * P,) for mid in edges
            for hi in (0, 1, (1 << 32) - 1)]
    rng = np.random.default_rng(71)
    vals += [int.from_bytes(rng.bytes(68), "little") for _ in range(8)]
    limbs = np.stack([lf.int_to_limbs(v, kernels.N_WORDS) for v in vals],
                     axis=-1)
    plain = kernels.fold_plain(lf.u32_to_tensor(limbs, "cpu"))
    host = lf.tensor_to_u32(plain)
    for j, v in enumerate(vals):
        assert split_fold(v) == lf.limbs_to_int(host[:, j]) == v % P
