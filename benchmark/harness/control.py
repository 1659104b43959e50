"""The controls: what each cell's check must refuse, run at a cell's size.

    python3 -m benchmark.harness.control --workload <cell> --seeds 1 2 3

* `openings2-h17.commit`: the reference itself in the program's place,
  its scalars cut to 224 bits (each coefficient's top 32-bit word
  dropped: a short-scalar MSM), against the exact reference;
* a proof cell (`opening-h17.batch`, or any whose loop subclasses
  `proofs.Loop`): the program's proofs from a prover compiled under
  another setup (a stale circuit cache), against the verifier key of the
  run's own setup.

Each prints, per seed, the numbers the cell's check compares.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import commits, core


class _Encoded:
    """A commitment given by its encoding, as the check reads one."""

    def __init__(self, raw: bytes):
        self.raw = raw

    def to_bytes(self) -> bytes:
        return self.raw


def commit_control(config, traffic, seed: int, device) -> dict:
    loop = commits.Loop(config, traffic, seed, device)
    loop.host_pool = commits.coefficient_sets(
        seed, traffic["sets"], traffic["polys_per_call"], loop.length,
        device).cpu().numpy()
    tau, g = commits.ref_srs.trapdoor(seed & commits.M64)
    control = loop.reference(tau, g, drop_top_limb=True)
    records = [{"set": s, "error": None, "out": [_Encoded(c) for c in outs]}
               for s, outs in enumerate(control)]
    return loop.check(records)


def proof_control(config, traffic, seed: int, device, n_proofs: int) -> dict:
    loop = core.loop_class(traffic)(config, dict(traffic, warmup=0), seed,
                                    device)
    loop.srs_seed = seed + 1
    loop.setup({})
    records = [loop.item() for _ in range(n_proofs)]
    loop.release()
    return loop.check(records)


def control(cell_name: str, seed: int, device="cuda", n_proofs=4) -> dict:
    bench = core.load_json(core.BENCH_DIR.parent / "BENCHMARK.json")
    _, config, traffic = core.find_cell(bench, cell_name)
    if traffic["loop"] == "commits":
        return commit_control(config, traffic, seed, device)
    return proof_control(config, traffic, seed, device, n_proofs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.harness.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t = time.monotonic()
        checks = control(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {k: v for k, (v, _) in checks.items()},
                          "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
