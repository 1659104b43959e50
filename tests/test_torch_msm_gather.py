"""The `msm_gather` kernel's plain version and the pipeline built on it,
on the CPU.

`kernels.msm_gather` gathers the MSM's bucket-sorted points and, in merge
mode, adds the halving tree's first level on the way.  On the CPU it runs
its plain version, the PyTorch composition the pipeline ran before the
kernel.  These tests hold the first level from merge mode
(`msm._first_level`) against `msm._tree_level` on the gather mode's points,
and the gather against the points' integers, on crafted sort outputs:
dead lanes, points at infinity, padding lanes, a row of one bucket, a row
whose every pair is split, a row all dead.

The kernel's own arithmetic runs only on the card
(`tests/test_torch_kernels_gpu.py`); the addition it uses in place of
`fq_lazy.cuh`'s, `g1_add_affine` (both points at z = 1, as every live row
of the point matrix is), is read out of `csrc/msm_gather.cu` and executed
here statement by statement on integers mod q, with the range of every
value tracked as `fq_lazy.cuh` states it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ptx_model import function_body
from zkvm_tpu_torch.ops import g1_ops, kernels, msm
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FQ

torch.set_num_threads(1)

SOURCE = (Path(kernels.CSRC) / "msm_gather.cu").read_text()
Q = FQ.modulus
R = 1 << 384
RINV = pow(R, -1, Q)


# -----------------------------------------------------------------------------
# Inputs: a point-major matrix and the outputs of one sort per digit row
# -----------------------------------------------------------------------------

def field_rows(rows: int, seed: int, identity: float = 0.02) -> torch.Tensor:
    """[rows, 36] int32 point-major Montgomery coordinates below q, as
    `msm.MSMContext` holds them: random x and y (the additions are
    identities of the formula, so points need not lie on the curve) at
    z = 1, and (0, 1, 0) on an `identity` share (the padding and the points
    at infinity of a commit key)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=(rows, 3, FQ.n_limbs),
                     dtype=np.uint64).astype(np.uint32)
    a[..., -1] = rng.integers(0, int(FQ.p_limbs[-1]), size=(rows, 3))
    a[:, 2] = FQ.one_mont
    ident = rng.random(rows) > 1 - identity
    a[ident] = 0
    a[ident, 1] = FQ.one_mont
    return lf.u32_to_tensor(a.reshape(rows, 3 * FQ.n_limbs), "cpu")


def sorted_rows(n: int, half: int, pm: torch.Tensor, seed: int):
    """(sid, neg, perm) [6, n] as `msm._sort_digits` gives them, each row
    sorted by (bucket, sign, index): random buckets with a dead tail (a
    digit 0 or the point at infinity, bucket half + 1); one bucket; every
    pair split (lane i in bucket (i + 1) // 2 + 1, dead past half); all
    dead; few buckets; the last lanes dead (padding).  A lane reading a
    point at infinity of pm (z = 0) is dead, as the sort makes it; the rows
    of one bucket and of split pairs read only the other points."""
    rng = np.random.default_rng(seed)
    sent = half + 1
    pinf = ~lf.tensor_to_u32(pm[:, 2 * FQ.n_limbs:]).any(axis=1)
    live = np.flatnonzero(~pinf)
    buckets = [rng.integers(1, half + 1, n),
               np.full(n, 3),
               np.minimum((np.arange(n) + 1) // 2 + 1, sent),
               np.full(n, sent),
               rng.integers(1, 4, n),
               np.where(np.arange(n) < n - n // 5, rng.integers(1, half + 1, n),
                        sent)]
    buckets[0][rng.random(n) < 0.1] = sent
    sid, neg, perm = [], [], []
    for r, bk in enumerate(buckets):
        sign = rng.random(n) < 0.5
        if r in (1, 2):
            idx = np.resize(rng.permutation(live), n)
        else:
            idx = rng.permutation(len(pinf))[:n]
            bk = np.where(pinf[idx], sent, bk)
        order = np.lexsort((idx, sign, bk)) if r != 2 else np.arange(n)
        sid.append(bk[order])
        neg.append(sign[order])
        perm.append(idx[order])
    return (torch.tensor(np.stack(sid), dtype=torch.int32),
            torch.tensor(np.stack(neg)),
            torch.tensor(np.stack(perm), dtype=torch.int64))


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(s, t) for s, t in zip(a, b))


# n lanes, half buckets: m = n / 2 at least half (the pipeline's case), and
# below it (the rejects padded to half slots)
SHAPES = [(256, 64), (256, 128), (64, 64)]


def gathered_ints(pm, sid, neg, perm, half, lanes):
    """The points of the given (row, lane) pairs from the integers of pm:
    (x, y, z), y negated mod q where neg is set, (0, 1, 0) where the lane
    is dead (sid > half)."""
    one = lf.limbs_to_int(FQ.one_mont)
    rows = lf.tensor_to_u32(pm)
    out = []
    for b, i in lanes:
        if sid[b, i] > half:
            out.append((0, one, 0))
            continue
        r = rows[int(perm[b, i])]
        x, y, z = (lf.limbs_to_int(r[12 * k:12 * k + 12]) for k in range(3))
        out.append((x, (Q - y) % Q if neg[b, i] else y, z))
    return out


def lane_ints(pts, lanes):
    cols = [lf.tensor_to_u32(t) for t in pts]
    return [tuple(lf.limbs_to_int(c[b, :, i]) for c in cols)
            for b, i in lanes]


@pytest.mark.parametrize("n,half", SHAPES)
def test_first_level_equals_the_composed_gather_and_tree_level(n, half):
    """Merge mode and the rejects' gather (`msm._first_level`) give what
    gather mode's points and `msm._tree_level` give: the level's ids, its
    points, the rejects' ids and points."""
    pm = field_rows(300, n + half)
    sid, neg, perm = sorted_rows(n, half, pm, half)
    got = msm._first_level(pm, sid, neg, perm, half)
    want = msm._tree_level(sid, kernels.msm_gather(pm, sid, neg, perm, half),
                           half)
    assert torch.equal(got[0], want[0])
    assert _equal(got[1], want[1])
    assert torch.equal(got[2][0], want[2][0])
    assert _equal(got[2][1], want[2][1])


@pytest.mark.parametrize("n,half", SHAPES)
def test_merge_mode_gives_the_sums_and_the_left_ids(n, half):
    """The left lanes' ids are the sentinel where a pair merged, else the
    left bucket; a lane at a bucket boundary is the right point itself.  On
    the rows `sorted_rows` makes: one bucket merges every pair, the split
    row none, the dead row parks every lane."""
    pm = field_rows(300, 7 * n)
    sid, neg, perm = sorted_rows(n, half, pm, 3 * half)
    pts, rsid = kernels.msm_gather(pm, sid, neg, perm, half, pairs=True)
    sl, sr = sid[:, 0::2], sid[:, 1::2]
    assert torch.equal(rsid, torch.where(sl == sr, half + 1, sl))
    split = [(b, j) for b in range(6) for j in range(n // 2)
             if sl[b, j] != sr[b, j]][::7]
    assert split
    assert lane_ints(pts, split) == gathered_ints(
        pm, sid, neg, perm, half, [(b, 2 * j + 1) for b, j in split])
    assert (rsid[1] == half + 1).all()
    assert (rsid[2, :min(n, 2 * half) // 2 - 1] <= half).all()
    assert (rsid[3] == half + 1).all()
    ident = g1_ops.identity_batch((n // 2,), "cpu")
    assert _equal(tuple(t[3] for t in pts), ident)


@pytest.mark.parametrize("n,half", SHAPES)
def test_gather_mode_equals_the_composed_gather(n, half):
    """The scan path's gather (no `src`) against the points' integers, and
    a gather at given lanes (the rejects') against the full gather at
    those lanes, parked by the output ids."""
    pm = field_rows(300, 11 * n)
    sid, neg, perm = sorted_rows(n, half, pm, 5 * half)
    full = kernels.msm_gather(pm, sid, neg, perm, half)
    lanes = [(b, i) for b in range(6) for i in range(0, n, 5)]
    assert lane_ints(full, lanes) == gathered_ints(pm, sid, neg, perm, half,
                                                   lanes)
    rng = np.random.default_rng(n)
    src = torch.tensor(rng.integers(0, n, (6, 40)), dtype=torch.int32)
    key = torch.tensor(rng.integers(1, half + 2, (6, 40)), dtype=torch.int32)
    got = kernels.msm_gather(pm, key, neg, perm, half, src=src)
    live = kernels.msm_gather(pm, torch.zeros_like(sid), neg, perm, half)
    at = tuple(msm._gather_lanes(t, src.to(torch.int64)) for t in live)
    assert _equal(got, g1_ops.park_identity(key > half, at))


def test_scan_path_gathers_through_the_kernel(monkeypatch):
    """`msm._sorted_points` (the scan path, n < PTREE_MIN_POINTS) launches
    the kernel once, in gather mode, and gives its points."""
    seen = []
    real = kernels.msm_gather
    monkeypatch.setattr(kernels, "msm_gather", lambda *a, **k: (
        seen.append(k), real(*a, **k))[1])
    pm = field_rows(128, 1)
    pinf = lf.is_zero(FQ, pm[:, 24:].T.contiguous())
    limbs = lf.FR.to_raw_array(list(range(10 ** 70, 10 ** 70 + 128)),
                               "cpu")[None]
    sid, *pts = msm._sorted_points(8, pm, pinf, limbs)
    assert seen == [{}]
    d = msm._signed_digit_tensors(limbs, 8)
    s2, neg, perm = msm._sort_digits(d, pinf, 128)
    assert torch.equal(sid, s2)
    assert _equal(pts, kernels.msm_gather(pm, sid, neg, perm, 128))
    # what merge mode's affine addition relies on: a live lane's point has
    # z = 1 (the rows at infinity are dead by the sort)
    z = pm[:, 2 * FQ.n_limbs:][perm[sid <= 128]]
    assert pinf.any() and torch.equal(
        z, lf.u32_to_tensor(FQ.one_mont, "cpu").expand_as(z))


def test_halving_tree_launches_merge_then_rejects(monkeypatch):
    """On the tree the first level is two launches: merge mode, then the
    rejects' gather at twice their lane positions; later levels none."""
    seen = []
    real = kernels.msm_gather
    monkeypatch.setattr(kernels, "msm_gather", lambda *a, **k: (
        seen.append(sorted(k)), real(*a, **k))[1])
    pm = field_rows(512, 2)
    pinf = lf.is_zero(FQ, pm[:, 24:].T.contiguous())
    rng = np.random.default_rng(4)
    limbs = torch.tensor(rng.integers(0, 1 << 31, (1, 8, 512)),
                         dtype=torch.int32)
    msm._msm_ptree_pipeline(6, pm, pinf, limbs)   # half 32: four levels
    assert seen == [["pairs"], ["src"]]


# -----------------------------------------------------------------------------
# The source: the kernel's name, its registration and its constants
# -----------------------------------------------------------------------------

def test_the_kernel_is_built_counted_and_named():
    assert "msm_gather.cu" in kernels._SOURCES
    assert "msm_gather" in kernels.LAUNCHES
    # the name a launch counter's kernels are found by in a trace
    assert re.search(r"__global__ void __launch_bounds__\(THREADS, "
                     r"BLOCKS_PER_SM\)\s*msm_gather_kernel\(", SOURCE)
    assert 'extern "C" int zk_msm_gather(' in SOURCE


def test_the_sources_constants_are_the_fields():
    body = SOURCE[SOURCE.index("uint32_t twelve(int i)"):][:400]
    words = [int(v, 16) for v in re.findall(r"0x[0-9a-f]{8}", body)][:12]
    assert lf.limbs_to_int(np.array(words, dtype=np.uint32)) == 12 * R % Q


def test_wrapper_checks_its_operands():
    pm = field_rows(40, 3)
    sid, neg, perm = sorted_rows(32, 16, pm, 1)
    with pytest.raises(ValueError, match="merge mode"):
        kernels.msm_gather(pm, sid, neg, perm, 16, src=sid, pairs=True)
    with pytest.raises(ValueError, match="merge mode"):
        kernels.msm_gather(pm, sid[:, :31].contiguous(), neg[:, :31]
                           .contiguous(), perm[:, :31].contiguous(), 16,
                           pairs=True)
    with pytest.raises(ValueError, match="expected"):
        kernels.msm_gather(pm, sid, neg, perm.to(torch.int32), 16)
    with pytest.raises(ValueError, match="expected"):
        kernels.msm_gather(pm, sid[:, :8].contiguous(), neg, perm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.msm_gather(pm, sid, neg, perm.T.contiguous().T, 16)
    with pytest.raises(ValueError, match="operands on"):
        kernels.msm_gather(pm, sid, neg.to("meta"), perm, 16)
    with pytest.raises(ValueError, match="not \\[B, N\\]"):
        kernels.msm_gather(pm, sid, neg, perm[0], 16)


# -----------------------------------------------------------------------------
# g1_add_affine, executed statement by statement on integers mod q
# -----------------------------------------------------------------------------

_STATEMENT = re.compile(
    r"\b(ld|mul|copy|add2q|sub2q|add12|fold_2q|reduce_q|times_3_12|st)"
    r"\(([^;]*)\);|\b(\w+)\[i\] = twelve\(i\);")


def affine_program():
    """The statements of `g1_add_affine` in order: (function, operands)."""
    body = function_body(SOURCE, "g1_add_affine")
    return [(m.group(1), [a.strip() for a in m.group(2).split(",")])
            if m.group(1) else ("twelve", [m.group(3)])
            for m in _STATEMENT.finditer(body)]


def run_affine(x1, y1, x2, y2):
    """Execute `g1_add_affine` on Montgomery integers below 2q: each
    variable a (residue, bound in units of q), every precondition of
    `fq_lazy.cuh` asserted.  Returns the three stored coordinates."""
    env, out = {}, {}
    inputs = {0: x1, 1: y1, 3: x2, 4: y2}
    for fn, ops in affine_program():
        if fn == "ld":
            env[ops[0]] = (inputs[int(ops[1])], 2.0)
        elif fn == "twelve":
            env[ops[0]] = (12 * R % Q, 1.0)
        elif fn == "mul":
            (a, ba), (b, bb) = env[ops[1]], env[ops[2]]
            assert ba < 8
            env[ops[0]] = (a * b * RINV % Q, ba * bb / 9.84 + 1)
        elif fn == "copy":
            env[ops[0]] = env[ops[1]]
        elif fn in ("add2q", "sub2q", "add12"):
            (a, ba), (b, bb) = env[ops[0]], env[ops[1]]
            sign = -1 if fn == "sub2q" else 1
            if fn != "add12":
                assert ba <= 2 and bb <= 2
            env[ops[0]] = ((a + sign * b) % Q,
                           ba + bb if fn == "add12" else 2.0)
        elif fn in ("fold_2q", "reduce_q"):
            a, ba = env[ops[0]]
            assert ba <= (4 if fn == "fold_2q" else 2)
            env[ops[0]] = (a, 2.0 if fn == "fold_2q" else 1.0)
        elif fn == "times_3_12":
            t, bt = env[ops[2]]
            assert bt <= 2
            env[ops[0]], env[ops[1]] = (3 * t % Q, 2.0), (12 * t % Q, 2.0)
        else:  # st
            v, bound = env[ops[1]]
            assert bound <= 1
            out[int(ops[0])] = v
    return out[0], out[1], out[2]


def test_affine_addition_is_the_complete_addition_at_z_one():
    """`g1_add_affine` on (x1, y1, 1) + (x2, y2, 1) gives `padd`'s limbs:
    ordinary sums, a doubling, P + (-P), y = 0 and edge values."""
    rng = np.random.default_rng(17)
    vals = [int(v) for v in rng.integers(0, 1 << 62, 40)]
    xs = [(v * 0x9E3779B97F4A7C15 ** 5) % Q for v in vals]
    lanes = [(xs[i], xs[i + 1], xs[i + 2], xs[i + 3]) for i in range(0, 36, 4)]
    lanes += [(xs[0], xs[1], xs[0], xs[1]),            # a doubling
              (xs[2], xs[3], xs[2], (Q - xs[3]) % Q),  # P + (-P)
              (xs[4], 0, xs[5], 0), (Q - 1, Q - 1, 0, 1)]
    one = lf.limbs_to_int(FQ.one_mont)
    cols = [[lf.int_to_limbs(v, 12) for v in col] for col in zip(*lanes)]
    t = [lf.u32_to_tensor(np.stack(c, axis=1), "cpu") for c in cols]
    ones = lf.u32_to_tensor(np.stack([FQ.one_mont] * len(lanes), axis=1),
                            "cpu")
    want = kernels.padd_plain((t[0], t[1], ones), (t[2], t[3], ones))
    assert one == R % Q
    for i, lane in enumerate(lanes):
        got = run_affine(*lane)
        assert got == tuple(lf.limbs_to_int(lf.tensor_to_u32(w[:, i]))
                            for w in want)


def test_affine_program_is_nine_products():
    prog = affine_program()
    assert sum(fn == "mul" for fn, _ in prog) == 9
    assert [ops for fn, ops in prog if fn == "ld"] == [
        ["a", "0"], ["b", "3"], ["c", "1"], ["d", "4"]]
    assert [ops[0] for fn, ops in prog if fn == "st"] == ["0", "1", "2"]
