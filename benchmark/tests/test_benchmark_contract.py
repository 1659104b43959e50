"""BENCHMARK.json against the benchmark's contract, and every cell's
configuration, traffic mix and per-layer reader found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", *KEYS, "run_seconds"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in (
                "lower", "higher")
            assert entry["source"] in SOURCES
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        traffic = json.loads(
            (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "harness" / f"{traffic['loop']}.py").is_file()
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def _reported(entries, cell):
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in [x["name"] for x in _reported(
                BENCH["end_to_end"], cell)]
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        names = [m["name"] for m in _reported(BENCH["end_to_end"], cell)]
        assert "setup_s" in names and len(names) >= 2
        assert _reported(BENCH["per_layer"], cell)


def test_run_seconds_fits_a_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    from benchmark.harness.core import load_reader

    assert callable(load_reader(metric))


# what a run calls of a cell's loop (`harness/core.py`)
PROTOCOL = ("setup", "item", "end_to_end", "release", "check")


def test_cells_are_found_by_name():
    from benchmark.harness import core

    for w in BENCH["workloads"]:
        cell, config, traffic = core.find_cell(BENCH, w["name"])
        assert cell is not None and config["name"] == w["config"]
        loop = core.loop_class(traffic)
        for method in PROTOCOL:
            assert callable(getattr(loop, method, None)), (w["name"], method)
