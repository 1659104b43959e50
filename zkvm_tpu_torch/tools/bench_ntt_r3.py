"""NTT times on the card: the 2^16 fft / ifft and the 2^19 coset pair the
quotient round uses.

The port's counterpart of `tools/bench_ntt_r3.py`.  `Domain(2^16)`'s
`fft_device` / `ifft_device` and `Domain(2^19)`'s `coset_fft_device` /
`coset_ifft_device` on one [8, n] Montgomery operand (`random.Random(3)`):
each transform's first call (twiddle and factor tables built, first
launches), then 20 calls chained on their own output, ending in a
synchronise, as ms a call and M elements/s.  Every transform is the
`ntt_stages` kernel (its plain version on the CPU).  After the timed chains
each domain's forward-then-inverse pair must give its operand back bit for
bit.

    python3 -m zkvm_tpu_torch.tools.bench_ntt_r3 [--device cuda]
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from ..fields import Fr
from ..ops.limb_field import FR
from ..ops.ntt import Domain
from . import print_card, sync

# (log2 n, the transform pair at that size), as in the reference's tool
SHAPES = ((16, ("fft", "ifft")), (19, ("coset_fft", "coset_ifft")))
REPS = 20


def run(shapes=SHAPES, device="cuda") -> list[dict]:
    """Time each transform (see the module's docstring).  Returns one dict
    a transform: log_n, kind, first_s, ms, melems_per_s, and `x` / `out`,
    its operand and its first call's result."""
    dev = torch.device(device)
    sync(dev)  # a CUDA device without a card raises here
    rng = random.Random(3)
    rows = []
    for lg, kinds in shapes:
        n = 1 << lg
        x = FR.to_mont_array([rng.randrange(Fr.MODULUS) for _ in range(n)],
                             dev)
        dom = Domain(n)
        for kind in kinds:
            fn = getattr(dom, kind + "_device")
            sync(dev)
            t0 = time.perf_counter()
            out = fn(x)
            sync(dev)
            first = time.perf_counter() - t0
            chained = out
            t0 = time.perf_counter()
            for _ in range(REPS):
                chained = fn(chained)
            sync(dev)
            dt = (time.perf_counter() - t0) / REPS
            rows.append({"log_n": lg, "kind": kind, "first_s": first,
                         "ms": dt * 1e3, "melems_per_s": n / dt / 1e6,
                         "x": x, "out": out})
            print(f"2^{lg} {kind}: first {first:.3f} s; {dt * 1e3:.4f} ms "
                  f"-> {n / dt / 1e6:.1f} M elems/s", flush=True)
        forward, inverse = (getattr(dom, k + "_device") for k in kinds)
        if not torch.equal(inverse(forward(x)), x):
            raise AssertionError(f"2^{lg}: {kinds[1]}({kinds[0]}(x)) != x")
    print("each forward-then-inverse pair gives its operand back bit for "
          "bit", flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.tools.bench_ntt_r3")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print_card(torch.device(args.device))
    run(SHAPES, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
