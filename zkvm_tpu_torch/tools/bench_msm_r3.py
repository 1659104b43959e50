"""MSM throughput of `MSMContext.msm` at several sizes on the card.

The port's counterpart of `tools/bench_msm_r3.py`.  The points come from
the same host chain of additions (G, then alternately doubled and
advanced by G), normalised in one batch; the scalars from
`random.Random(42)`.  At each size 2^k it prints the first call (size-class
caches and first launches) and the mean of three warm calls, each ending
in a synchronise, as ms and points/s; host scalar conversion is part of
`msm`.  At the end the MSM of the first 2^10 points (or all, if fewer)
must equal the host `msm_variable_base`.

    python3 -m zkvm_tpu_torch.tools.bench_msm_r3 [log_n ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from ..curves.g1 import G1Affine, G1Projective
from ..curves.msm import msm_variable_base
from ..fields import Fr
from ..ops.msm import MSMContext
from . import print_card, sync

SAMPLE_LOG_N = 10
REPS = 3


def chain_points(n: int) -> list[G1Affine]:
    """n distinct points by the reference tool's host chain of additions."""
    base = G1Affine.generator().to_projective()
    acc, points = base, []
    for _ in range(n):
        points.append(acc)
        acc = acc + acc if len(points) % 2 else acc + base
    return G1Projective.batch_normalize(points)


def run(sizes=(16,), device="cuda") -> dict:
    """Time `MSMContext.msm` at each 2^size (see the module's docstring).
    Returns {"rows": one dict a size, "sample": the checked MSM}."""
    dev = torch.device(device)
    sync(dev)  # a CUDA device without a card raises here
    n_max = 1 << max(sizes)
    t0 = time.perf_counter()
    points = chain_points(n_max)
    print(f"point gen: {time.perf_counter() - t0:.3f} s", flush=True)
    rng = random.Random(42)
    scalars = [Fr(rng.randrange(Fr.MODULUS)) for _ in range(n_max)]
    ctx = MSMContext(points, dev)

    rows = []
    for lg in sizes:
        n = 1 << lg
        sub = scalars[:n]
        t0 = time.perf_counter()
        ctx.msm(sub)
        sync(dev)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(REPS):
            ctx.msm(sub)
            sync(dev)
        dt = (time.perf_counter() - t0) / REPS
        rows.append({"log_n": lg, "first_s": first, "ms": dt * 1e3,
                     "points_per_s": n / dt})
        print(f"2^{lg} first call: {first:.3f} s; warm {dt * 1e3:.3f} ms -> "
              f"{n / dt:.1f} points/s", flush=True)

    m = min(1 << SAMPLE_LOG_N, n_max)
    sample = ctx.msm(scalars[:m])
    if sample != msm_variable_base(points[:m], scalars[:m]):
        raise AssertionError("MSMContext.msm differs from the host MSM on "
                             "the sample")
    print(f"sample of {m} points equals the host MSM", flush=True)
    return {"rows": rows, "sample": sample}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.bench_msm_r3")
    parser.add_argument("sizes", type=int, nargs="*", default=[16],
                        help="log2 of each MSM size")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print_card(torch.device(args.device))
    run(args.sizes, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
