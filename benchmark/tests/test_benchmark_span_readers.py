"""The readers of the program's inner spans on synthetic windows: the
prover's host time no span covers, garbage-collection pauses, the
in-circuit Poseidon and the MSM's host pace.  Nested keys are summed by
their last span, only top-level keys close a proof's accounting, and a
window without the spans reads None."""

from __future__ import annotations

import pytest

from benchmark.harness.core import Window, load_reader

RECORDS = [{"wall": 0.6, "prove": 0.5, "error": None},
           {"wall": 0.8, "prove": 0.7, "error": None}]
PROOF_SPANS = {
    "prove/witness_synthesis": (0.5, 2),
    "prove/witness_synthesis/prove/poseidon_gadget": (0.4, 34),
    "prove/preamble": (0.04, 2),
    "prove/preamble/prove/gc": (0.03, 2),
    "prove/wire_ingest": (0.1, 2),
    "prove/round1_wires": (0.1, 2),
    "prove/round1_wires/prove/msm/ingest": (0.01, 2),
    "prove/round1_wires/prove/msm/sort/prove/gc": (0.002, 1),
    "prove/round2_permutation": (0.1, 2),
    "prove/round3_quotient": (0.1, 2),
    "prove/round3_quotient/prove/gc": (0.05, 1),
    "prove/round4_evaluations": (0.1, 2),
    "prove/round5_openings": (0.1, 2),
    "prove/gc": (0.02, 3),  # outside every span: the service's steps
}


def test_unspanned_time_is_the_prove_less_the_top_level_spans():
    w = Window(RECORDS, 2.0, PROOF_SPANS, None)
    # 1.2 s of prove; top-level spans 0.5 + 0.04 + 0.1 x 6 = 1.14 s
    assert load_reader("prove_unspanned_ms")(w) == pytest.approx(30.0)
    failed = [dict(RECORDS[0]), {"wall": 0.1, "prove": 0.0, "error": "x"}]
    assert load_reader("prove_unspanned_ms")(
        Window(failed, 2.0, {"prove/round1_wires": (0.1, 1)}, None)
    ) == pytest.approx(400.0)


def test_gc_and_gadget_sum_every_nesting_per_proof():
    w = Window(RECORDS, 2.0, PROOF_SPANS, None)
    # 0.03 + 0.002 + 0.05 + 0.02 s of pauses over 2 proofs
    assert load_reader("prove_gc_ms")(w) == pytest.approx(51.0)
    assert load_reader("poseidon_gadget_ms")(w) == pytest.approx(200.0)


def test_msm_host_pace_counts_each_key_by_its_last_span():
    records = [{"set": i, "error": None, "out": []} for i in range(4)]
    spans = {"prove/msm/ingest": (0.004, 4),
             "prove/msm/signed digits": (0.008, 4),
             "prove/msm/sort": (0.012, 4),
             "prove/msm/sort/prove/gc": (0.5, 1),   # inside sort: counted
             "prove/msm/tree level 1": (0.016, 4),  # once, by sort
             "prove/msm/window_fold": (0.02, 4),
             "prove/msm/host decode": (0.04, 4),    # the read-back wait
             "prove/gc": (0.3, 2)}
    w = Window(records, 1.0, spans, None)
    assert load_reader("msm_host_ms")(w) == pytest.approx(15.0)
    nested = {"prove/round1_wires/prove/msm/ingest": (0.004, 4),
              "prove/round1_wires": (1.0, 4)}
    assert load_reader("msm_host_ms")(
        Window(records, 1.0, nested, None)) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["prove_unspanned_ms", "prove_gc_ms",
                                  "poseidon_gadget_ms", "msm_host_ms"])
def test_a_window_without_the_spans_reads_none(name):
    assert load_reader(name)(Window(RECORDS, 2.0, {}, None)) is None
    assert load_reader(name)(Window([], 2.0, PROOF_SPANS, None)) is None
    others = {"prove/round1_wires": (0.1, 1), "prove/gc_x": (0.1, 1)}
    if name != "prove_unspanned_ms":
        assert load_reader(name)(Window(RECORDS, 2.0, others, None)) is None
