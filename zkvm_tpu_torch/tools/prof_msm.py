"""Per-stage profile of one MSM of 2^16 points on the card.

The port's counterpart of `tools/prof_msm.py`.  Calls `MSMContext.
msm_many` with a stage hook: the pipeline of `ops/msm.py` enters it around
each of its stages, and the hook synchronises the card on both sides and
reads the host clock.  It prints the time of each stage, averaged over warm
repetitions:

  scalar conversion (host ints -> limb tensor on the card), signed digits,
  sort (packed keys, one sort per digit row), gather (the points by that
  permutation, y negated by the sign, dead lanes parked), each level of the
  halving tree (one addition, the rejects' sort and gather), the scan tail
  (prefix scan of the residual and the bucket differences), the folds of
  each level's rejects into the buckets, the weighted fold (suffix scan and
  lane sum), the `window_fold` kernel, and the host decode.

The sum of the stages is printed beside the wall of one `msm` call without
the hook, and the result is held against the host MSM.

    python3 -m zkvm_tpu_torch.tools.prof_msm [--log-n 16] [--reps 3] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import time
from collections import defaultdict

import torch

from .. import native
from ..curves.g1 import G1Affine
from ..fields import Fp, Fr
from ..ops import g1_ops
from ..ops import msm as M


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.prof_msm")
    parser.add_argument("--log-n", type=int, default=16)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    n = 1 << args.log_n

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)
    rng = random.Random(42)
    points = g1_ops.batch_scalar_mul_base(
        G1Affine.generator(),
        [Fr(rng.randrange(Fr.MODULUS)) for _ in range(n)], dev)
    scalars = [Fr(rng.randrange(Fr.MODULUS)) for _ in range(n)]
    ctx = M.MSMContext(points, dev)
    if M._granule(n) < M.PTREE_MIN_POINTS:
        raise ValueError(f"{n} points take the scan path, not the tree")

    totals: dict[str, float] = defaultdict(float)

    class stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            sync()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            sync()
            totals[self.name] += time.perf_counter() - self.t0

    got = ctx.msm_many([scalars], stage=stage)[0]  # warm-up, size classes
    host = native.native_msm(points, scalars)
    if host is None:
        raise RuntimeError("the native MSM library is unavailable")
    x, y, inf = host
    if got.to_affine() != (G1Affine.identity() if inf
                           else G1Affine(Fp(x), Fp(y))):
        raise AssertionError("MSMContext.msm differs from the host MSM")
    totals.clear()
    for _ in range(args.reps):
        ctx.msm_many([scalars], stage=stage)
    walls = []
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        ctx.msm(scalars)
        sync()
        walls.append(time.perf_counter() - t0)

    stages_ms = {k: v / args.reps * 1e3 for k, v in totals.items()}
    staged_ms = sum(stages_ms.values())
    for name, ms in stages_ms.items():
        print(f"  {name:18s} {ms:9.3f} ms {100 * ms / staged_ms:5.1f}%",
              flush=True)
    wall_ms = sum(walls) / len(walls) * 1e3
    print(f"stages summed {staged_ms:.3f} ms; one msm without the hook "
          f"{wall_ms:.3f} ms = {n / wall_ms * 1e3:.1f} points/s", flush=True)
    print(json.dumps({"metric": f"msm_stages_ms_2^{args.log_n}",
                      "stages": stages_ms, "staged_ms": staged_ms,
                      "msm_ms": wall_ms, "device": str(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
