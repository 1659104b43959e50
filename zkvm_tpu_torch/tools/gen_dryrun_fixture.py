"""Regenerate the dryrun fixture, `tests/fixtures/dryrun_proof_v1.bin`.

The port's counterpart of `tools/gen_dryrun_fixture.py`: proves the dryrun
circuit of `utils/dryrun.py` (a height-1 Poseidon-tree opening, StdRng
seeds 42 / 7, an SRS of 2^11) on `--device`, verifies the proof, and writes
it with its public inputs in the fixture's layout (`dryrun.write_fixture`).
Run it after an intentional change of the proof bytes; `--out` writes
elsewhere, which is how a run checks that the port still makes the
committed bytes.

    python3 -m zkvm_tpu_torch.tools.gen_dryrun_fixture [--out PATH] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..utils import dryrun
from . import print_card


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.gen_dryrun_fixture")
    parser.add_argument("--out", default=None,
                        help="where to write (default: the committed fixture)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print_card(torch.device(args.device))
    t0 = time.perf_counter()
    prover, verifier = dryrun.dryrun_prover(args.device)
    proof, pis = dryrun.prove_dryrun(prover)
    verifier.verify(proof, pis)
    path = args.out or dryrun.fixture_path()
    n = dryrun.write_fixture(proof, pis, path)
    print(f"fixture written to {path} ({n} bytes) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
