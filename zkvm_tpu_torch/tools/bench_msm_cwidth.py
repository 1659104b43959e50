"""Sweep of the halving-tree MSM's window width c on the card.

The port's counterpart of `tools/bench_msm_cwidth.py`: the bucket pipeline
`msm._msm_ptree_pipeline(c, ...)` at 2^16 points for c = 11, 12 and 13,
over one scalar set (S = 1) and four (S = 4), each timed as the mean of
three calls after a warm one, every call ending in a synchronise; then
`_fold_windows` of its window sums.  `_ptree_window_bits` picks c = 11 at
2^16; this measures what the others would give on this card.

Checks, any failure ends the run: at each c, `window_fold` (which takes c
and W = ceil(260 / c) at run time: 24, 22, 20) equals its plain version on
the same window sums; every c and every set gives the same point, and that
point equals the native host MSM (`native_msm`) over all the points.  Each
row names the sort `_sort_digits` takes at that c: the packed i32 key while
it fits, the stable sort of (bucket, sign) past it.

    python3 -m zkvm_tpu_torch.tools.bench_msm_cwidth [--device cuda]

Like the reference tool, the command line has no size or width flag; the
tests call `sweep` at a small size.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import native
from ..curves.g1 import G1Affine, G1Projective
from ..fields import Fp
from ..ops import kernels
from ..ops import msm as M
from ..ops.limb_field import FR
from ..utils.benches import msm_inputs
from . import print_card, sync

WIDTHS = (11, 12, 13)
SETS = (1, 4)
REPS = 3


def window_count(c: int) -> int:
    """W: the signed-digit windows of a 256-bit scalar at width c."""
    return kernels.digit_windows(c)


def sort_kind(c: int, n: int) -> str:
    """Which sort `_sort_digits` takes for n lanes at width c."""
    return "packed" if kernels.packed_key_fits(1 << (c - 1), n) else "stable"


def width_points(c: int, pm, pinf, limbs) -> list[G1Projective]:
    """One pipeline at width c over [S, 8, n] canonical limbs, `window_fold`
    held against its plain version on its window sums, then the S points."""
    n_sets, n = limbs.shape[0], limbs.shape[-1]
    sums = tuple(t.contiguous() for t in
                 M._msm_ptree_pipeline(c, pm, pinf, limbs))
    w = window_count(c)
    if not torch.equal(kernels.window_fold(c, w, n_sets, *sums),
                       kernels.window_fold_plain(c, w, n_sets, *sums)):
        raise AssertionError(f"window_fold differs from its plain version "
                             f"at c = {c}, W = {w}, S = {n_sets}")
    return M._fold_windows(sums, c, n_sets, [n] * n_sets)


def native_point(points, scalars) -> G1Projective:
    res = native.native_msm(points, scalars)
    if res is None:
        raise RuntimeError("the native MSM library is unavailable")
    x, y, inf = res
    return (G1Projective.identity() if inf
            else G1Affine(Fp(x), Fp(y)).to_projective())


def sweep(log_n: int = 16, widths=WIDTHS, device="cuda") -> dict:
    """Time and check the pipeline at each width (see the module's
    docstring).  Returns {"rows": one dict a (c, S), "point": the MSM}."""
    dev = torch.device(device)
    sync(dev)  # a CUDA device without a card raises here
    n = 1 << log_n
    points, scalars = msm_inputs(n, dev)  # the headline's
    ctx = M.MSMContext(points, dev)
    pm, pinf = ctx._padded(n)
    limbs1 = FR.to_raw_array([s.value for s in scalars], ctx.device)[None]
    by_sets = {s: limbs1.expand(s, -1, -1).contiguous() for s in SETS}

    rows, ref = [], None
    for c in widths:
        for n_sets, limbs in by_sets.items():
            M._msm_ptree_pipeline(c, pm, pinf, limbs)  # warm
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(REPS):
                M._msm_ptree_pipeline(c, pm, pinf, limbs)
                sync(dev)
            dt = (time.perf_counter() - t0) / REPS
            got = width_points(c, pm, pinf, limbs)
            ref = got[0] if ref is None else ref
            if any(p != ref for p in got):
                raise AssertionError(f"c = {c}, S = {n_sets}: the MSM "
                                     f"differs from the first width's")
            row = {"c": c, "W": window_count(c), "sets": n_sets,
                   "sort": sort_kind(c, n), "ms": dt * 1e3,
                   "points_per_s": n_sets * n / dt}
            rows.append(row)
            print(f"c={c} W={row['W']} S={n_sets} sort={row['sort']}: "
                  f"{row['ms']:.3f} ms  {row['points_per_s']:.1f} points/s",
                  flush=True)
    if ref != native_point(points, scalars):
        raise AssertionError("the sweep's MSM differs from the native host "
                             "MSM")
    print(f"every window width gives the same point, equal to the native "
          f"host MSM over all 2^{log_n} points; window_fold equals its "
          f"plain version at each", flush=True)
    return {"rows": rows, "point": ref}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.bench_msm_cwidth")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print_card(torch.device(args.device))
    out = sweep(16, WIDTHS, args.device)
    print(json.dumps({"metric": "msm_window_sweep_2^16",
                      "rows": out["rows"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
