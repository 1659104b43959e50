"""The arithmetic of the numbers a run reports: p90 over every sample,
the traced window's busy and idle time from a synthetic trace, the
launch check, the roofline bounds pinned to the repository's values,
and the per-layer readers on a synthetic window."""

from __future__ import annotations

import statistics
from pathlib import Path

import pytest

from benchmark.harness import roofline, trace
from benchmark.harness.commits import Loop as CommitLoop
from benchmark.harness.core import Window, load_reader
from benchmark.harness.proofs import Loop as ProofLoop


def test_p90_is_over_every_leaf_of_the_window():
    walls = [0.5 + 0.01 * i for i in range(80)]
    records = [{"wall": w, "prove": 0.4, "error": None} for w in walls]
    records[3]["error"] = "boom"  # a failed leaf: not done, still timed
    w = Window(records, 40.0, {}, None)
    assert load_reader("proof_rate")(w) == pytest.approx(79 / 40.0)
    p90 = load_reader("proof_wall_p90_s")(w)
    assert p90 == pytest.approx(
        statistics.quantiles(walls, n=10, method="inclusive")[8])
    assert p90 == pytest.approx(0.5 + 0.01 * 71.1)
    empty = Window([], 40.0, {}, None)
    assert load_reader("proof_rate")(empty) is None
    assert load_reader("proof_wall_p90_s")(empty) is None


def test_proof_device_ms_is_the_windows_busy_time_per_proof():
    loop = ProofLoop.__new__(ProofLoop)
    records = [{"wall": 0.5, "prove": 0.4, "error": None} for _ in range(80)]
    records[3]["error"] = "boom"  # not done: its device time still counts
    dev = trace.DeviceWindow(busy_s=2.37, missing_launches=0)
    got = loop.end_to_end(records, 40.0, dev)
    assert got == {"proof_device_ms": pytest.approx(1e3 * 2.37 / 79)}
    assert loop.end_to_end(records, 40.0, None) == {"proof_device_ms": None}


def test_commit_device_ms_and_commit_rate_are_over_the_window():
    loop = CommitLoop.__new__(CommitLoop)
    length = 65_538
    records = [{"set": i % 8, "out": [0] * 4, "points": 4 * length,
                "error": None} for i in range(500)]
    records[7].update(out=[], points=0, error="boom")  # never answered
    dev = trace.DeviceWindow(busy_s=4.6, missing_launches=0)
    got = loop.end_to_end(records, 50.0, dev)
    assert got == {"commit_device_ms": pytest.approx(1e3 * 4.6 / 499)}
    assert loop.end_to_end(records, 50.0, None) == {"commit_device_ms": None}
    w = Window(records, 50.0, {}, None)
    assert load_reader("commit_rate")(w) == pytest.approx(
        499 * 4 * length / 50.0)
    assert load_reader("commit_rate")(Window([], 50.0, {}, None)) is None


def _synthetic_events():
    ms = 1_000_000  # ns
    return [
        (trace.WINDOW, False, 0, 100 * ms),
        ("bench/prove", False, 0, 60 * ms),
        ("prove/round3_quotient", False, 10 * ms, 40 * ms),
        ("bench/verify", False, 60 * ms, 100 * ms),
        ("bench/prove", True, 0, 60 * ms),  # a device-side annotation
        ("void padd_kernel<12>(int*)", True, 5 * ms, 15 * ms),
        ("padd_kernel", True, 12 * ms, 20 * ms),   # overlaps the first
        ("ntt_pass_kernel", True, 50 * ms, 55 * ms),
        ("Memcpy DtoH (Device -> Pageable)", True, 58 * ms, 61 * ms),
        ("empty_kernel", True, -5 * ms, -4 * ms),  # the pad: before the window
    ]


def test_busy_and_idle_from_a_synthetic_trace():
    tr = trace.summarize(_synthetic_events(), 2, {"padd": 2, "ntt_stages": 1},
                         {"padd": [10, 20]})
    assert tr.window_s == pytest.approx(0.100)
    # busy: [5, 20] + [50, 55] + [58, 61] ms
    assert tr.busy_s == pytest.approx(0.023)
    assert tr.kernel_s["padd_kernel"] == pytest.approx(0.018)
    assert tr.kernel_n == {"padd_kernel": 2, "ntt_pass_kernel": 1,
                           "Memcpy DtoH": 1}
    idle = tr.idle_by_range
    # gaps: [0, 5], [20, 50], [55, 58], [61, 100]; round 3 holds [20, 40]
    # of the second, bench/prove the rest of the first three
    assert idle["bench/prove"] == pytest.approx(0.018)
    assert idle["prove/round3_quotient"] == pytest.approx(0.020)
    assert idle["bench/verify"] == pytest.approx(0.039)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert trace.missing_launches(tr) == 0
    b = tr.breakdown()
    assert b["device_ops"][0] == ["padd_kernel", pytest.approx(0.018)]
    assert b["idle_gaps"][0][0] == "bench/verify"
    w = Window([], 1.0, {}, tr)
    assert load_reader("device_idle.prove")(w) == pytest.approx(77.0)


def test_a_window_that_misses_launches_is_seen():
    tr = trace.summarize(_synthetic_events(), 1,
                         {"padd": 3, "ntt_stages": 1, "quotient": 1}, {})
    assert trace.missing_launches(tr) == 2


def test_device_busy_of_a_card_only_trace():
    # every device event counts, host ranges are absent, the pad is not
    events = [e for e in _synthetic_events() if e[1]
              and not e[0].startswith("bench/")]
    got = trace.device_busy(events, {"padd": 2, "ntt_stages": 1})
    assert got.busy_s == pytest.approx(0.023)
    assert got.missing_launches == 0
    assert trace.device_busy(events, {"padd": 3, "quotient": 1}
                             ).missing_launches == 2
    assert trace.device_busy([], {}).busy_s == 0


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(_synthetic_events()[1:], 1, {}, {})


def test_roofline_arithmetic_is_the_repositorys():
    assert roofline.mont_mul_ops(8) == 272 and roofline.mont_mul_ops(12) == 600
    # PERF.md's kernel table: ntt_stages at [4, 8, 2^19] bounds at
    # 0.2895 ms by operations (17.83 M products); padd at [24, 12, 32768]
    # at 0.3380 ms by operations
    assert roofline.ntt_products(4, 19) == 17_825_796
    assert roofline.ntt_bound_s(4, 19) * 1e3 == pytest.approx(0.28947, abs=5e-5)
    assert roofline.padd_bound_s(24 * 32768) * 1e3 == pytest.approx(
        0.33804, abs=5e-5)


def test_rooflines_and_device_time_readers():
    tr = trace.Trace(window_s=1.0, busy_s=0.25, items=10,
                     kernel_s={"padd_kernel": 2 * roofline.padd_bound_s(1000),
                               "ntt_pass_kernel": 4 * roofline.ntt_bound_s(2, 15)},
                     kernel_n={}, idle_by_range={}, launches={},
                     lanes={"padd": [600, 400], "ntt_stages": [(2, 15)]})
    w = Window([], 1.0, {}, tr)
    assert load_reader("padd_roofline")(w) == pytest.approx(50.0, rel=1e-3)
    assert load_reader("ntt_roofline")(w) == pytest.approx(25.0)
    assert load_reader("msm_device_ms")(w) == pytest.approx(25.0)
    assert load_reader("device_idle.commit")(w) == pytest.approx(75.0)
    empty = Window([], 1.0, {}, None)
    for name in ("padd_roofline", "ntt_roofline", "msm_device_ms",
                 "device_idle.prove"):
        assert load_reader(name)(empty) is None


def test_span_and_host_clock_readers():
    records = [{"wall": 0.6, "prove": 0.5, "error": None},
               {"wall": 0.8, "prove": 0.6, "error": None}]
    spans = {"prove/witness_synthesis": (0.5, 2),
             "prove/wire_ingest": (0.1, 2), "prove/round1_wires": (0.1, 2),
             "prove/round2_permutation": (0.1, 2),
             "prove/round3_quotient": (0.1, 2),
             "prove/round4_evaluations": (0.1, 2),
             "prove/round5_openings": (0.1, 2)}
    w = Window(records, 2.0, spans, None)
    assert load_reader("service_overhead_ms")(w) == pytest.approx(150.0)
    assert load_reader("witness_synthesis_ms")(w) == pytest.approx(250.0)
    assert load_reader("rounds_ms")(w) == pytest.approx(300.0)
    assert load_reader("rounds_ms")(Window(records, 2.0, {}, None)) is None


def test_lane_counters_wrap_and_restore():
    import torch

    class FakeKernels:
        LAUNCHES = {}

        @staticmethod
        def padd(p, q, layouts=None):
            return p

        @staticmethod
        def ntt_stages(x, tw):
            return x

    k = FakeKernels()
    real = (k.padd, k.ntt_stages)
    with trace.lane_counters(k) as lanes:
        k.padd((torch.zeros(3, 12, 5),) * 3, None)
        k.ntt_stages(torch.zeros(4, 8, 16), None)
    assert lanes == {"padd": [15], "ntt_stages": [(4, 4)]}
    assert (k.padd, k.ntt_stages) == real


def test_layer_metric_files_are_the_benchmarks():
    files = sorted(p.stem for p in (Path(__file__).resolve().parents[1]
                                    / "layer_metrics").glob("*.py"))
    import json

    bench = json.loads((Path(__file__).resolve().parents[2]
                        / "BENCHMARK.json").read_text())
    assert files == sorted(m["name"] for m in bench["per_layer"])
