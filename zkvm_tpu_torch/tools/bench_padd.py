"""The two G1 addition kernels alone over MSM-scale lane counts.

The port's counterpart of `tools/bench_padd.py`.  The MSM's bucket stages
are complete G1 additions over [rows, 12, lanes] batches; this probes the
kernels alone on such a batch (default 20 x 65536): P and Q gathered from
256 seeded points (`random.Random(7)`), Q's indexes P's rolled by one lane.
It runs `kernels.padd` (the counterpart of `padd_pallas` / `padd_pallas_2l`)
and `kernels.padd_ilp` (of `padd_pallas_ilp` / `padd_pallas_ilp2l`): for
each, the first call, then five calls ending in a synchronise, as ms, ns an
addition lane and M additions/s.  The two results must be equal on the
first 64 lanes of every row, and equal to `kernels.padd_plain` there.

The reference tool's `block` argument (the Pallas block of lanes) has no
counterpart: each kernel's launch bounds are compiled into its source
(`csrc/padd.cu`, `csrc/padd_ilp.cu`).  Both kernels always run, since
their equality is the check.

    python3 -m zkvm_tpu_torch.tools.bench_padd [rows] [lanes] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import random
import time

import numpy as np
import torch

from ..curves.g1 import G1Projective
from ..ops import g1_ops, kernels
from . import print_card, sync

VARIANTS = {"padd": kernels.padd, "padd_ilp": kernels.padd_ilp}
CHECKED_LANES = 64
REPS = 5


def batch(rows: int, lanes: int, device):
    """P and Q, each an (x, y, z) triple of [rows, 12, lanes] int32
    Montgomery limbs gathered from 256 seeded points; Q's point indexes are
    P's rolled by one lane."""
    rng = random.Random(7)
    g = G1Projective.generator()
    base = [(g * rng.getrandbits(64)).to_affine() for _ in range(256)]
    coords = g1_ops.affine_to_device(base, device)  # [12, 256] each
    idx = np.asarray([rng.randrange(256) for _ in range(rows * lanes)],
                     dtype=np.int64).reshape(rows, lanes)

    def gather(ix):
        ix = torch.from_numpy(ix).to(coords[0].device)
        return tuple(t[:, ix].transpose(0, 1).contiguous() for t in coords)

    return gather(idx), gather(np.roll(idx, 1, axis=1))


def run(rows: int = 20, lanes: int = 65536, device="cuda") -> list[dict]:
    """Time each addition kernel (see the module's docstring).  Returns one
    dict a kernel: name, first_s, ms, ns_per_add, madds_per_s."""
    dev = torch.device(device)
    sync(dev)  # a CUDA device without a card raises here
    p, q = batch(rows, lanes, dev)
    head = min(CHECKED_LANES, lanes)
    plain = kernels.padd_plain(*(tuple(t[..., :head].cpu() for t in pt)
                                 for pt in (p, q)))
    n = rows * lanes
    rows_out = []
    for name, fn in VARIANTS.items():
        sync(dev)
        t0 = time.perf_counter()
        out = fn(p, q)
        sync(dev)
        first = time.perf_counter() - t0
        if not all(torch.equal(o[..., :head].cpu(), w)
                   for o, w in zip(out, plain)):
            raise AssertionError(f"{name} differs from padd_plain on the "
                                 f"first {head} lanes")
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn(p, q)
        sync(dev)
        dt = (time.perf_counter() - t0) / REPS
        rows_out.append({"name": name, "first_s": first, "ms": dt * 1e3,
                         "ns_per_add": dt / n * 1e9,
                         "madds_per_s": n / dt / 1e6})
        print(f"{name} [{rows}, 12, {lanes}]: first {first:.3f} s; "
              f"{dt * 1e3:.4f} ms -> {dt / n * 1e9:.4f} ns/padd-lane "
              f"({n / dt / 1e6:.2f} M adds/s)", flush=True)
    print(f"each kernel equals padd_plain (and so the other) on the first "
          f"{head} lanes of every row", flush=True)
    return rows_out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.bench_padd")
    parser.add_argument("rows", type=int, nargs="?", default=20)
    parser.add_argument("lanes", type=int, nargs="?", default=65536)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print_card(torch.device(args.device))
    run(args.rows, args.lanes, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
