"""zkvm_tpu_torch.ops.msm against the host MSM and the JAX pipeline.

The port adds points in another order than zkvm_tpu (a log-depth scan),
so MSM results are compared as group elements, through canonical bytes:
against zkvm_tpu's `curves.msm.msm_variable_base` and, for the halving
tree, against the JAX `_msm_ptree_pipeline` + `_host_window_fold` on the
same numpy-seeded inputs.  Signed digits are integers and must match
exactly.  The port gets its own host points and scalars; the reference gets
the same values as its classes.
"""

import numpy as np
import pytest
import torch

import jax

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.curves.msm import msm_variable_base as ref_msm_variable_base
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu_torch.curves.g1 import G1Projective
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu.ops import limb_field as rlf
from zkvm_tpu.ops import msm as rmsm
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import msm

torch.set_num_threads(1)


def _points(n, seed):
    """n affine points A + i*S for numpy-seeded multiples A, S of G."""
    rng = np.random.default_rng(seed)
    g = G1Projective.generator()
    a = g * int(rng.integers(1, 1 << 62))
    s = g * int(rng.integers(1, 1 << 62))
    out = []
    for _ in range(n):
        out.append(a)
        a = a + s
    return G1Projective.batch_normalize(out)


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    return [Fr(sum(int(w) << (63 * k) for k, w in enumerate(row)))
            for row in words]


def _ref_points(points):
    """The same affine points as the reference's class."""
    return [RG1Affine.identity() if p.infinity
            else RG1Affine(RFp(p.x.value), RFp(p.y.value)) for p in points]


def _ref_msm_bytes(points, scalars) -> bytes:
    """zkvm_tpu's host MSM of the same points and scalars, compressed."""
    want = ref_msm_variable_base(_ref_points(points),
                                 [RFr(s.value) for s in scalars])
    return want.to_affine().to_bytes()


def _adversarial(scalars):
    """Zero, one, duplicates, p - 1 and lone high bits mixed in."""
    out = list(scalars)
    out[:9] = [Fr.zero(), Fr.one(), Fr.one(), Fr(2), out[20],
               Fr(Fr.MODULUS - 1), Fr(1 << 200), Fr(513), Fr(1 << 255)]
    return out


@pytest.mark.parametrize("c", [8, 10, 11, 12])
def test_signed_digits_match_reference(c):
    vals = [s.value for s in _adversarial(_scalars(300, c))]
    ref_limbs = np.asarray(rlf.FR.to_raw_array(vals)).reshape(16, 3, 100)
    ref_limbs = np.ascontiguousarray(ref_limbs.transpose(1, 0, 2))
    want = np.asarray(rmsm._signed_digit_tensors(ref_limbs, c))
    got = msm._signed_digit_tensors(
        lf.from_reference(ref_limbs, lf.FR, "cpu"), c)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


def test_sort_fallback_orders_as_the_packed_key():
    """Where the packed i32 key fits (n = 300, c = 8), the stable sort that
    takes over where it overflows gives the same (sid, neg, perm)."""
    c = 8
    half = 1 << (c - 1)
    vals = [s.value for s in _adversarial(_scalars(300, 7))]
    limbs = lf.FR.to_raw_array(vals, "cpu")[None]
    d = msm._signed_digit_tensors(limbs, c)
    pinf = torch.zeros(300, dtype=torch.bool)
    pinf[[3, 40]] = True
    sid, neg, perm = msm._sort_digits(d, pinf, half)
    dflat = d.reshape(-1, 300)
    bucket = torch.where(dflat == 0, half + 1, dflat.abs())
    bucket = torch.where(pinf[None, :], half + 1, bucket)
    got = msm._sort_stable(bucket, (dflat < 0).to(torch.int32))
    assert torch.equal(got[0], sid) and torch.equal(got[1], neg)
    assert torch.equal(got[2], perm)


def test_sort_digits_past_the_packed_key():
    """At [1, 1, 2^18] with half = 4096 the packed key overflows i32; the
    rows still sort by (bucket, sign, index), as a numpy lexsort does."""
    n, half = 1 << 18, 4096
    assert ((half + 1) << ((n - 1).bit_length() + 1)) >= (1 << 31)
    rng = np.random.default_rng(9)
    d = torch.from_numpy(rng.integers(-half, half + 1, size=(1, 1, n),
                                      dtype=np.int32))
    pinf = torch.from_numpy(rng.random(n) < 0.01)
    sid, neg, perm = msm._sort_digits(d, pinf, half)
    dn = d.reshape(n).numpy()
    bucket = np.where((dn == 0) | pinf.numpy(), half + 1, np.abs(dn))
    order = np.lexsort((np.arange(n), dn < 0, bucket))
    assert (perm[0].numpy() == order).all()
    assert (sid[0].numpy() == bucket[order]).all()
    assert (neg[0].numpy() == (dn[order] < 0)).all()


def test_scan_path_matches_host():
    """MSMContext.msm below PTREE_MIN_POINTS: the prefix-scan pipeline,
    with a point at infinity and a duplicate point."""
    n = 1000
    points = _points(n, 1)
    points[10] = points[11]
    points[12] = -points[13]
    scalars = _adversarial(_scalars(n, 2))
    ctx = msm.MSMContext(points, "cpu")
    assert (ctx.msm(scalars).to_affine().to_bytes()
            == _ref_msm_bytes(points, scalars))


def test_ptree_pipeline_forced_matches_jax_and_host():
    """The halving tree forced at n = 2048, c = 10 (half = 512, two levels,
    reject compaction and the scan tail), as the reference's own test."""
    n, c = 2048, 10
    points = _points(n, 3)
    points[5] = points[4]  # doubling inside a bucket
    scalars = _adversarial(_scalars(n, 4))
    scalars[4] = scalars[5]

    ctx = msm.MSMContext(points, "cpu")
    pm, pinf = ctx._padded(n)
    limbs = lf.FR.to_raw_array([s.value for s in scalars], "cpu")[None]
    sums = msm._msm_ptree_pipeline(c, pm, pinf, limbs)
    got = msm._fold_windows(sums, c, 1, [n])[0]

    rctx = rmsm.MSMContext(_ref_points(points))
    _, rpinf, rpm = rctx._padded(n)
    rlimbs = rlf.FR.to_raw_array([s.value for s in scalars])[None]
    rsums = rmsm._msm_ptree_pipeline(c, rpm, rpinf, rlimbs)
    host = [np.asarray(t) for t in jax.device_get(rsums)]
    want = rmsm._host_window_fold(host, c, host[0].shape[0], 1, [n])[0]
    assert got.to_affine().to_bytes() == want.to_affine().to_bytes()
    assert got.to_affine().to_bytes() == _ref_msm_bytes(points, scalars)


def test_multi_set_prefixes_match_host():
    """msm_many over prefixes of one point set (the commit_many shape),
    including an empty set."""
    points = _points(300, 5)
    sets = [_scalars(k, 6 + k) for k in (300, 211, 77)] + [[]]
    got = msm.MSMContext(points, "cpu").msm_many(sets)
    for g, s in zip(got, sets):
        assert (g.to_affine().to_bytes()
                == _ref_msm_bytes(points[:len(s)], s))


class _Recorder:
    """A stage hook that records the names the pipeline enters, in order,
    and checks that the stages do not nest."""

    def __init__(self):
        self.names = []
        self.open = False

    def __call__(self, name):
        self.names.append(name)
        return self

    def __enter__(self):
        assert not self.open
        self.open = True

    def __exit__(self, *exc):
        self.open = False


def test_stage_hook_on_the_scan_path():
    """`msm_many(..., stage=)` enters every stage of the scan path once, in
    order, and gives the same point as the call without the hook."""
    points = _points(100, 7)
    scalars = _scalars(100, 8)
    ctx = msm.MSMContext(points, "cpu")
    rec = _Recorder()
    got = ctx.msm_many([scalars], stage=rec)[0]
    assert rec.names == ["scalar conversion", "signed digits", "sort",
                         "gather", "scan tail", "weighted fold",
                         "window_fold", "host decode"]
    assert (got.to_affine().to_bytes()
            == ctx.msm(scalars).to_affine().to_bytes()
            == _ref_msm_bytes(points, scalars))


def test_stage_hook_on_the_halving_tree():
    """The halving tree forced at n = 1024, c = 10 (one level): the hook
    sees each level, the scan tail, the reject folds and the fold stages,
    and the hooked pipeline gives the host's point."""
    n, c = 1024, 10
    points = _points(n, 9)
    scalars = _scalars(n, 10)
    ctx = msm.MSMContext(points, "cpu")
    pm, pinf = ctx._padded(n)
    limbs = lf.FR.to_raw_array([s.value for s in scalars], "cpu")[None]
    rec = _Recorder()
    sums = msm._msm_ptree_pipeline(c, pm, pinf, limbs, rec)
    got = msm._fold_windows(sums, c, 1, [n], rec)[0]
    assert rec.names == ["signed digits", "sort", "gather", "tree level 1",
                         "scan tail", "reject folds", "weighted fold",
                         "window_fold", "host decode"]
    assert got.to_affine().to_bytes() == _ref_msm_bytes(points, scalars)
