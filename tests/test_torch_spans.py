"""The program's spans (`zkvm_tpu_torch/utils/metrics.py`) where the
prover's fixture proof does not reach them: a garbage collection as the
span `prove/gc`, the in-circuit Poseidon permutation as
`prove/poseidon_gadget`, and the rule that a span is a profiler range only
inside the program's own trace window (`padded_profile`)."""

import gc
import importlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zkvm_tpu_torch.curves.g1 import G1Affine
from zkvm_tpu_torch.hashes.gadget import GadgetPermutation
from zkvm_tpu_torch.ops import kernels, msm
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.plonk.composer import Composer
from zkvm_tpu_torch.service.batch import OpeningCircuit
from zkvm_tpu_torch.utils import metrics


def _gc_reading():
    return (metrics.GLOBAL.counts.get("prove/gc", 0),
            metrics.GLOBAL.totals.get("prove/gc", 0.0))


def _collect_once():
    """(count, seconds) that one `gc.collect()` adds to `prove/gc`, with
    automatic collection held off meanwhile."""
    was = gc.isenabled()
    gc.disable()
    try:
        n0, s0 = _gc_reading()
        gc.collect()
        n1, s1 = _gc_reading()
    finally:
        if was:
            gc.enable()
    return n1 - n0, s1 - s0


def test_a_collection_is_one_gc_span_and_a_reload_adds_no_hook():
    n, s = _collect_once()
    assert n == 1 and s > 0
    # a collection on another thread is not booked: the stack is the
    # importing thread's
    other = []
    t = threading.Thread(target=lambda: other.append(_collect_once()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and other == [(0, 0.0)]
    hooks = len(gc.callbacks)
    kept = metrics.GLOBAL, metrics.Metrics
    try:
        importlib.reload(metrics)
        assert len(gc.callbacks) == hooks
        n, s = _collect_once()
        assert n == 1 and s > 0
    finally:
        metrics.GLOBAL, metrics.Metrics = kept
    n, s = _collect_once()
    assert n == 1 and s > 0


def test_a_pause_inside_a_span_nests_under_it():
    metrics.GLOBAL.reset()
    was = gc.isenabled()
    gc.disable()
    try:
        with metrics.GLOBAL.span("prove/round3_quotient"):
            gc.collect()
    finally:
        if was:
            gc.enable()
    spans = metrics.report()
    assert spans["prove/round3_quotient/prove/gc"]["count"] == 1
    assert spans["prove/round3_quotient"]["count"] == 1


def test_poseidon_gadget_span_counts_each_permutation(monkeypatch):
    """The opening circuit at height 2 synthesised as the prover does it:
    one span `prove/poseidon_gadget` a permutation, nested in the witness
    synthesis."""
    calls = []
    real = GadgetPermutation.permute

    def counting(self, state):
        calls.append(1)
        return real(self, state)

    monkeypatch.setattr(GadgetPermutation, "permute", counting)
    metrics.GLOBAL.reset()
    with metrics.GLOBAL.span("prove/witness_synthesis"):
        OpeningCircuit.default_for_height(2).circuit(Composer.initialized())
    spans = metrics.report()
    assert len(calls) >= 2
    key = "prove/witness_synthesis/prove/poseidon_gadget"
    assert spans[key]["count"] == len(calls)
    assert 0 < spans[key]["total_s"] <= spans[
        "prove/witness_synthesis"]["total_s"]


def _program_ranges(prof) -> list[str]:
    return [ev.name() for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith("prove/")]


def test_spans_are_profiler_ranges_only_in_the_programs_window(monkeypatch):
    """A commit MSM of one point, its point additions and window fold
    replaced by stand-ins (on the CPU their plain versions take seconds and
    ~1.4M profiler events a call; only the ranges are read here)."""
    monkeypatch.setattr(kernels, "padd",
                        lambda p, q, layouts=None: tuple(
                            t.contiguous() for t in p))
    monkeypatch.setattr(kernels, "window_fold",
                        lambda c, w, s, x, y, z: torch.zeros(
                            (3, lf.FQ.n_limbs, s), dtype=torch.int32))
    ctx = msm.MSMContext([G1Affine.generator()], "cpu")
    coeffs = lf.FR.to_mont_array([3], "cpu")
    stages = ["prove/msm/ingest", "prove/msm/signed digits",
              "prove/msm/sort", "prove/msm/gather", "prove/msm/scan tail",
              "prove/msm/weighted fold", "prove/msm/window_fold",
              "prove/msm/host decode"]
    with profile(activities=[ProfilerActivity.CPU]) as outside:
        ctx.msm_many_mont([coeffs])
    assert _program_ranges(outside) == []
    with metrics.padded_profile("cpu") as inside:
        ctx.msm_many_mont([coeffs])
    assert sorted(n for n in _program_ranges(inside)
                  if n != "prove/gc") == sorted(stages)
    with profile(activities=[ProfilerActivity.CPU]) as after:
        ctx.msm_many_mont([coeffs])
    assert _program_ranges(after) == []


def test_the_window_closes_its_ranges_on_an_exception():
    with pytest.raises(RuntimeError):
        with metrics.padded_profile("cpu"):
            raise RuntimeError("inside the window")
    with profile(activities=[ProfilerActivity.CPU]) as after:
        with metrics.GLOBAL.span("prove/preamble"):
            pass
    assert _program_ranges(after) == []
