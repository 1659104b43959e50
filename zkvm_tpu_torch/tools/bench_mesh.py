"""The flagship prove over device meshes, beside the single-device prove.

Compiles the 2^16-gate flagship once on `cuda:0` (`utils.benches.
run_flagship`, one warm prove), then proves it over each mesh the caller
names: `--shards k` logical shards of `cuda:0`, and `--cards m` the cards
`cuda:0` .. `cuda:m-1` (nothing here counts the cards; a card that does
not exist raises).  For each mesh: the first prove and `--reps` warm
proves, each byte-identical to the single-device proof, the spans of the
warm proves, a single-device warm prove in the same turn, and
`dryrun_multichip` on the same mesh.  Every device step is synchronised
before the clock is read.

    python3 -m zkvm_tpu_torch.tools.bench_mesh [--shards 4] [--cards 0] \\
        [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..ops.collective import Mesh
from ..rng import StdRng
from ..utils import dryrun, metrics
from ..utils.benches import run_flagship


def _timed_prove(prover, circuit, mesh=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof, _ = prover.prove(StdRng(7), circuit, mesh=mesh)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, proof.to_bytes()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.bench_mesh")
    parser.add_argument("--shards", type=int, default=4,
                        help="logical shards of cuda:0 (0: none)")
    parser.add_argument("--cards", type=int, default=0,
                        help="a mesh over cuda:0 .. cuda:<cards-1> (0: none)")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    home = torch.device("cuda", 0)
    meshes = []
    if args.shards:
        meshes.append(Mesh([home] * args.shards))
    if args.cards:
        meshes.append(Mesh([f"cuda:{i}" for i in range(args.cards)]))

    r = run_flagship(home, reps=1)
    prover, circuit = r["prover"], r["circuit"]
    want = r["proof"].to_bytes()
    for mesh in meshes:
        first, blob = _timed_prove(prover, circuit, mesh)
        blobs = {blob}
        metrics.GLOBAL.reset()
        warm = []
        for _ in range(args.reps):
            wall, blob = _timed_prove(prover, circuit, mesh)
            warm.append(wall)
            blobs.add(blob)
        spans = metrics.report()
        single, blob = _timed_prove(prover, circuit)
        blobs.add(blob)
        if blobs != {want}:
            raise AssertionError(f"a proof over {mesh} differs from the "
                                 f"single-device proof")
        t0 = time.perf_counter()
        dryrun.dryrun_multichip(mesh)
        dryrun_s = time.perf_counter() - t0
        print(json.dumps({
            "mesh": [str(d) for d in mesh.devices], "card": card,
            "first_s": first, "warm_s": warm, "single_warm_s": single,
            "spans_s": {k: v["total_s"] / v["count"]
                        for k, v in spans.items()},
            "dryrun_multichip_s": dryrun_s, "bytes_equal": True}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
