"""The closed loop of KZG10 commitments: `CommitKey.commit_many_mont` on a
prover's round-1 batch, one call at a time.

Set-up draws the deployment's SRS from the seed, trims the commit key to
the circuit's domain (`PublicParameters.trim`), and makes `sets` sets of
`polys_per_call` device-resident Montgomery coefficient tensors, [8, L]
int32 with L = 2^domain_log2 + `extra_coefficients` (the blinded wire
polynomials of round 1), from a torch.Generator seeded on the device.
Each item commits the next set in turn.  The end-to-end metric is the
card's busy time over the whole window, from the window's card-only
trace, per call finished in it (`commit_device_ms`); the calls' rate on
the harness's clock, which the host paces, is the per-layer
`commit_rate`.  After the window the reference works out every set's
commitments as [p(tau)] g and compares every call's.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.plonk import PublicParameters
from zkvm_tpu_torch.rng import StdRng

from ..reference import commit as ref_commit
from ..reference import srs as ref_srs
from ..reference.field import R

M64 = (1 << 64) - 1
R_TOP = R >> 224  # the top 32-bit word of r


def coefficient_sets(seed: int, sets: int, polys: int, length: int, device):
    """[sets, polys, 8, length] int32 words below r, uniform but for the
    top word, which is drawn below r's (so every value is below r)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & M64)
    shape = (sets, polys, 8, length)
    words = torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                          dtype=torch.int64)
    words[:, :, 7] = torch.randint(0, R_TOP, (sets, polys, length),
                                   generator=gen, device=device,
                                   dtype=torch.int64)
    return words.to(torch.int32)


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.n = 1 << config["domain_log2"]
        self.srs_log2 = config["srs_log2"]
        self.length = self.n + traffic["extra_coefficients"]
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.count = 0

    def setup(self, parts: dict) -> None:
        t = time.monotonic()
        if self.device != "cpu":
            kernels.build()
        parts["kernels"] = time.monotonic() - t
        t = time.monotonic()
        pp = PublicParameters.setup(1 << self.srs_log2,
                                    StdRng(self.seed & M64), self.device)
        self.key, _ = pp.trim(self.n)
        del pp
        parts["srs"] = time.monotonic() - t
        t = time.monotonic()
        self.pool = coefficient_sets(self.seed, self.traffic["sets"],
                                     self.traffic["polys_per_call"],
                                     self.length, self.device)
        parts["inputs"] = time.monotonic() - t
        t = time.monotonic()
        for _ in range(self.traffic["warmup"]):
            self.item()
        parts["warmup"] = time.monotonic() - t

    def item(self) -> dict:
        s = self.count % self.traffic["sets"]
        self.count += 1
        rec = {"set": s, "error": None, "out": []}
        with record_function("bench/commit"):
            try:
                rec["out"] = self.key.commit_many_mont(list(self.pool[s]))
            except Exception as err:  # the answer never came: counted failed
                rec["error"] = f"{type(err).__name__}: {err}"
        rec["points"] = len(rec["out"]) * self.length
        return rec

    def end_to_end(self, records, window_s: float, window_dev=None) -> dict:
        """`commit_device_ms`: the card's busy time over the window, from
        the window's own trace (`window_dev`), per call finished in it."""
        done = sum(r["error"] is None for r in records)
        return {"commit_device_ms": (1e3 * window_dev.busy_s / done
                                     if window_dev is not None and done
                                     else None)}

    def release(self) -> None:
        self.host_pool = self.pool.cpu().numpy()
        self.key = self.pool = None
        gc.collect()

    def reference(self, tau: int, g, drop_top_limb=False):
        """[set][poly] -> the compressed commitment the reference works out."""
        return [[ref_commit.commitment(limbs, tau, g, drop_top_limb)
                 for limbs in polys] for polys in self.host_pool]

    def check(self, records) -> dict:
        """Every commitment of the run against the reference: wrong (not
        the reference's point) or missing (fewer than a call's sets)."""
        tau, g = ref_srs.trapdoor(self.seed & M64)
        want = self.reference(tau, g)
        wrong = missing = 0
        for rec in records:
            got = [c.to_bytes() for c in rec["out"]]
            missing += len(want[rec["set"]]) - len(got)
            wrong += sum(a != b for a, b in zip(got, want[rec["set"]]))
        return {"commits_wrong": (wrong, 0), "commits_missing": (missing, 0)}
