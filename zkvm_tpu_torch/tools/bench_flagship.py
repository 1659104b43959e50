"""Flagship end-to-end bench on the card: the 2^16-gate MultiOpeningCircuit.

The port's counterpart of `tools/bench_flagship.py`.  Prints what
`utils.benches.run_flagship` measures (the same function times
`chip_smoke.py`'s flagship phase): the one-time path (SRS setup 2^17 after
an untimed setup of 2^8 that takes the process's first device work,
compile/preprocess), the first and the warm proves, verify, and the
per-round span breakdown (including witness synthesis, which runs on the
host and is part of every proof).  Every device step is synchronised
before the clock is read.

    python3 -m zkvm_tpu_torch.tools.bench_flagship [count=21] \\
        [capacity_log2=17] [reps=3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..utils.benches import run_flagship


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.bench_flagship")
    parser.add_argument("count", type=int, nargs="?", default=21,
                        help="openings of a height-3 tree in the circuit")
    parser.add_argument("capacity_log2", type=int, nargs="?", default=17)
    parser.add_argument("reps", type=int, nargs="?", default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)
    r = run_flagship(dev, args.count, args.capacity_log2, args.reps)
    prover = r["prover"]
    warm = sum(r["warm_s"]) / len(r["warm_s"])
    print(f"srs_setup 2^{args.capacity_log2} (after a 2^8 warm-up setup): "
          f"{r['setup_s']:.3f}s", flush=True)
    print(f"compile/preprocess: {r['compile_s']:.3f}s "
          f"(gates={prover.constraints} domain={prover.size})", flush=True)
    print(f"prove_first: {r['prove_first_s']:.3f}s", flush=True)
    print(f"prove_warm: {warm:.3f}s ("
          + ", ".join(f"{w:.3f}" for w in r["warm_s"])
          + f"; byte-identical)", flush=True)
    print("spans (avg per prove):", flush=True)
    for name, v in r["spans"].items():
        print(f"  {name}: {v['total_s'] / v['count']:.4f}s", flush=True)
    print(f"verify: {r['verify_ms']:.1f} ms", flush=True)
    if r["peak_gib"] is not None:
        print(f"peak device memory of the proves: {r['peak_gib']:.3f} GiB",
              flush=True)
    print(json.dumps({"metric": "prove_warm_2^16_gates", "value": warm,
                      "unit": "s", "device": str(dev),
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
