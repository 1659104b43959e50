"""Benchmark entry point of the port: prints ONE JSON line with the headline
metric.

The port's counterpart of the root `bench.py`, with its keys and metric
name.  Headline: G1 Pippenger MSM throughput (points/s) on the card at 2^16
points -- the KZG commitments of the 2^16-gate flagship dominate the PLONK
prover.  The unit under test is the device MSM as the prover consumes it:
`MSMContext.msm_many_mont` on device-resident Montgomery coefficients (the
host scalar conversion is not on that path); one warm call, then the mean
of three, each ending in a synchronise.

`vs_baseline` compares with the port's pure-Python host MSM
(`curves.msm.msm_variable_base`, the reference's algorithm, one thread) on
the first 2^10 points, extrapolated linearly to 2^16: values above 1 mean
the card beats a faithful single-thread CPU implementation.  The run fails
unless the device MSM of that sample equals the host's.

    python3 -m zkvm_tpu_torch.bench [--device cuda]
    python3 -m zkvm_tpu_torch.bench --all | --only msm,ntt [--device cuda]

`--all` / `--only` run the per-operation suite (`utils.benches.run_all`),
one JSON line a row.  The device defaults to `cuda`; asked for `cuda`
without a card, the run raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .utils.benches import msm_inputs, sync

SAMPLE_LOG_N = 10  # the host baseline's and the sample check's size


def headline(log_n: int = 16, device="cuda") -> dict:
    """The headline measurement at 2^log_n points on `device`, over
    `utils.benches.msm_inputs` (the root `bench.py`'s seeded points and
    scalars).  Returns {"row": the printed JSON object, "result": the MSM
    of all points, "points", "scalars", "device_s": mean seconds of one
    MSM, "host_s": the host baseline's extrapolated seconds}."""
    from .curves.msm import msm_variable_base
    from .ops import limb_field as lf
    from .ops.limb_field import FR
    from .ops.msm import MSMContext

    dev = torch.device(device)
    sync(dev)  # a CUDA device without a card raises here
    n = 1 << log_n
    points, scalars = msm_inputs(n, dev)

    ctx = MSMContext(points, dev)
    coeffs = lf.u32_to_tensor(FR.to_mont_array_np([s.value for s in scalars]),
                              ctx.device)
    result = ctx.msm_many_mont([coeffs])[0]  # size-class caches, first launch
    sync(dev)
    runs = 3
    t0 = time.perf_counter()
    for _ in range(runs):
        result = ctx.msm_many_mont([coeffs])[0]
        sync(dev)
    device_s = (time.perf_counter() - t0) / runs

    m = min(1 << SAMPLE_LOG_N, n)
    t0 = time.perf_counter()
    host_part = msm_variable_base(points[:m], scalars[:m])
    host_s = (time.perf_counter() - t0) * (n / m)
    if ctx.msm(scalars[:m]) != host_part:
        raise AssertionError("device MSM mismatch on the host sample")

    row = {"metric": "msm_g1_points_per_sec_2^16",
           "value": round(n / device_s, 1),
           "unit": "points/s",
           "vs_baseline": round(host_s / device_s, 3)}
    return {"row": row, "result": result, "points": points,
            "scalars": scalars, "device_s": device_s, "host_s": host_s}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m zkvm_tpu_torch.bench",
        description="the MSM headline of the port, one JSON line")
    parser.add_argument("--all", action="store_true",
                        help="run every row of utils.benches instead")
    parser.add_argument("--only", default=None,
                        help="comma-separated rows of utils.benches instead")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.all or args.only is not None:
        from .utils.benches import run_all

        only = [s for s in (args.only or "").split(",") if s]
        run_all(only or None, args.device)
        return 0
    print(json.dumps(headline(device=args.device)["row"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
