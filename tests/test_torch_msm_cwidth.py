"""The MSM window sweep (`zkvm_tpu_torch/tools/bench_msm_cwidth.py`) on the
CPU, against `zkvm_tpu`.

At 2^8 seeded scalars over the MSM probe's chain of points, for each width
c = 11, 12, 13: the port's halving-tree pipeline and window fold
(`width_points`, which holds `window_fold` against its plain version) give
`zkvm_tpu`'s `_msm_ptree_pipeline` + `_fold_windows` at the same c (JAX on
its CPU backend), which is the host MSM's, compared exactly as compressed
bytes.  The pipeline's scan over 2^(c-1) buckets makes each width 13-29 s
of plain CPU arithmetic, hence a file of its own.
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.curves.msm import msm_variable_base as ref_msm_variable_base
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import msm as rmsm
from zkvm_tpu.ops.limb_field import FR as RFR
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import msm
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.tools import bench_msm_cwidth, bench_msm_r3

torch.set_num_threads(1)

SWEEP_LOG_N = 8


def _ref_points(points):
    return [RG1Affine.identity() if p.infinity
            else RG1Affine(RFp(p.x.value), RFp(p.y.value)) for p in points]


def _bytes(point) -> bytes:
    return point.to_affine().to_bytes()


@pytest.fixture(scope="module")
def sweep_inputs():
    n = 1 << SWEEP_LOG_N
    points = bench_msm_r3.chain_points(n)
    rng = np.random.default_rng(41)
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    scalars = [Fr(sum(int(w) << (63 * k) for k, w in enumerate(row)))
               for row in words]
    ctx = msm.MSMContext(points, "cpu")
    pm, pinf = ctx._padded(n)
    limbs = FR.to_raw_array([s.value for s in scalars], "cpu")[None]
    return points, scalars, pm, pinf, limbs


@pytest.mark.parametrize("c", bench_msm_cwidth.WIDTHS)
def test_sweep_width_equals_the_reference_pipeline(c, sweep_inputs):
    """At each width the port's pipeline + window fold (held against
    `window_fold_plain` inside `width_points`) gives `zkvm_tpu`'s point,
    which is the host MSM's."""
    points, scalars, pm, pinf, limbs = sweep_inputs
    n = len(points)
    got = bench_msm_cwidth.width_points(c, pm, pinf, limbs)
    assert len(got) == 1

    rctx = rmsm.MSMContext(_ref_points(points))
    _, rpinf, rpm = rctx._padded(n)
    rlimbs = RFR.to_raw_array([s.value for s in scalars])[None]
    want = rmsm._fold_windows(rmsm._msm_ptree_pipeline(c, rpm, rpinf, rlimbs),
                              c, 1, [n])[0]
    assert _bytes(got[0]) == _bytes(want)
    assert _bytes(want) == _bytes(ref_msm_variable_base(
        _ref_points(points), [RFr(s.value) for s in scalars]))


def test_sweep_window_counts_and_sorts():
    """W is the digit rows `_signed_digit_tensors` makes (24, 22, 20), and
    the sort is the packed key at 2^16 for every width; past 2^17 at c = 13
    the key overflows and `_sort_digits` takes the stable sort."""
    limbs = torch.zeros((1, 8, 4), dtype=torch.int32)
    assert [bench_msm_cwidth.window_count(c)
            for c in bench_msm_cwidth.WIDTHS] == [
        msm._signed_digit_tensors(limbs, c).shape[1]
        for c in bench_msm_cwidth.WIDTHS] == [24, 22, 20]
    assert [bench_msm_cwidth.sort_kind(c, 1 << 16)
            for c in bench_msm_cwidth.WIDTHS] == ["packed"] * 3
    assert bench_msm_cwidth.sort_kind(13, 1 << 18) == "stable"
    assert bench_msm_cwidth.sort_kind(12, 1 << 18) == "packed"
