"""Time a few kernels of the checkout this runs in, for a comparison of two
checkouts in turns in one call on the card.

    python3 /path/to/zkvm_tpu_torch/tools/kernel_times.py LABEL

Run from the root of a checkout (this one, or a parent commit unpacked with
`git archive` into a git-ignored directory): it imports that checkout's
`zkvm_tpu_torch`, builds its kernels and prints one JSON line of CUDA-event
times (ms, three runs each) of `ntt_stages` at [4, 8, 2^19], `fold` at [17,
2^16] and [17, 2^21], `carry_fold` at [68, 2^21] and `quotient` at [8,
2^19] and [8, 2^18] x 28 operands and on a mesh shard's [8, 2^17] part of
the 2^19 operands read in place, on seeded canonical operands, beside the
card's name and power limit.  Running it as parent,
this one, this one, parent compares the two on one card.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zkvm_tpu_torch.ops import kernels, ntt  # noqa: E402
from zkvm_tpu_torch.ops import limb_field as lf  # noqa: E402
from zkvm_tpu_torch.tools import card  # noqa: E402
from zkvm_tpu_torch.tools.quotient_bounds import (  # noqa: E402
    operands as quotient_operands)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches enqueued while the card
    spins."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA GPU")
    kernels.build()
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 32, size=(4, 8, 1 << 19),
                     dtype=np.uint64).astype(np.uint32)
    a[:, -1] = rng.integers(0, int(lf.FR.p_limbs[-1]), size=(4, 1 << 19))
    x = lf.u32_to_tensor(a, "cuda")
    tw = ntt.Domain(1 << 19)._butterfly_tables(torch.device("cuda"))[0]
    out = {"checkout": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": card()}
    out["ntt_stages_4x2^19"] = [
        cuda_ms(lambda: kernels.ntt_stages(x, tw), 20) for _ in range(3)]
    for lanes in (1 << 16, 1 << 21):
        w = lf.u32_to_tensor(rng.integers(0, 1 << 32, size=(17, lanes),
                                          dtype=np.uint64).astype(np.uint32),
                             "cuda")
        out[f"fold_{lanes}"] = [cuda_ms(lambda: kernels.fold(w), 50)
                                for _ in range(3)]
    d = np.zeros((68, 1 << 21), dtype=np.int32)
    d[:63] = rng.integers(0, 1 << 24, size=(63, 1 << 21))
    d = torch.from_numpy(d).to("cuda")
    out["carry_fold_2^21"] = [cuda_ms(lambda: kernels.carry_fold(d), 20)
                              for _ in range(3)]
    del d
    for log_lanes in (19, 18):
        ops, table = quotient_operands(1 << log_lanes, rng)
        out[f"quotient_2^{log_lanes}"] = [
            cuda_ms(lambda: kernels.quotient(ops, table), 10)
            for _ in range(3)]
        if log_lanes == 19:  # the second of four shards, read in place
            part = [t[:, 1 << 17:2 << 17] for t in ops]
            out["quotient_shard_2^17"] = [
                cuda_ms(lambda: kernels.quotient(part, table), 10)
                for _ in range(3)]
        del ops
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
