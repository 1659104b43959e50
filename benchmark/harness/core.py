"""One run of one cell of the benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (its file under
`benchmark/configs/`) and a traffic mix (`benchmark/traffic/<mix>.json`),
whose `loop` names the closed loop that drives it (`harness/<loop>.py`).
That module defines `Loop`, built as `Loop(config, traffic, seed, device)`,
with the methods a run calls in this order:

* `setup(parts)`: everything before the window, each part's seconds
  written into the dict `parts`;
* `item()`: one item of the window, a dict whose `error` is None unless
  the answer never came;
* `end_to_end(records, window_s, window_dev)`: the cell's end-to-end
  metrics but `setup_s`, from the window's records (`window_dev`, the
  card-only trace of the window, where one of them is read from the
  device);
* `release()`: the program's state freed;
* `check(records)`: every record judged by the plain reference, as
  {name: (number, limit)}.

A loop for another circuit of a proving service subclasses `proofs.Loop`.
A run sets the cell up (timed as `setup_s`, its parts printed on an
earlier line), measures for `--seconds` seconds, and with `--trace 1`
first profiles `trace_items` items of the same loop and reads the cell's
per-layer metrics (`benchmark/layer_metrics/<metric>.py`).  Where one of
the cell's end-to-end metrics comes from the device (`"source":
"device_trace"`), the `--trace 0` window runs under a profiler that
records the card alone (`trace.device_window`).  The profiler is the
benchmark's instrument, not the program's: it starts after `setup_s` is
taken and before the window's clock does.  After the
window it reads the device's peak memory, frees the program's state, and
has the plain reference judge every output of the window.  The last line
of standard output is the result; the numbers compared end standard
error, each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
# the JAX package and what it loads: none may be imported by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "zkvm_tpu")
TRACE_TRIES = 3


class Window:
    """What a per-layer reader may read: the measured window's records and
    seconds, the program's span totals over it, the traced window."""

    def __init__(self, records, window_s, spans, trace):
        self.records = records
        self.window_s = window_s
        self.spans = spans      # span name -> (total seconds, count)
        self.trace = trace      # trace.Trace, or None in an untraced run

    def span_mean_s(self, *names: str):
        """Summed span seconds of `names` per item of the window, or None
        if the window holds none of them."""
        total = sum(self.spans.get(n, (0.0, 0))[0] for n in names)
        count = max((self.spans.get(n, (0.0, 0))[1] for n in names),
                    default=0)
        return total / len(self.records) if count and self.records else None


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(BENCH_DIR.parent / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_for(entries, cell_name: str):
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def load_reader(name: str):
    path = BENCH_DIR / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_layer_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop_class(traffic: dict):
    """The `Loop` of the traffic's loop module, `harness/<loop>.py`."""
    return importlib.import_module(f"benchmark.harness.{traffic['loop']}").Loop


def card_line(torch, chips: int) -> dict:
    """The card's name and power limit (nvidia-smi), for every number."""
    out = {"kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def span_totals(metrics) -> dict:
    return {k: (v, metrics.GLOBAL.counts[k])
            for k, v in metrics.GLOBAL.totals.items()}


def run_window(loop, seconds: float) -> tuple[list, float, int]:
    """The closed loop for `seconds`: items until the time is up."""
    records, failed = [], 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        rec = loop.item()
        failed += rec.get("error") is not None
        records.append(rec)
    return records, time.monotonic() - t0, failed


def run(argv, t_start: float, device: str = "cuda", check_card=True) -> int:
    """One run; returns the exit code.  `check_card=False` and a CPU
    `device` drive the same run without a card (the harness's tests)."""
    args = parse_args(argv)
    bench = load_json(BENCH_DIR.parent / "BENCHMARK.json")
    cell, config, traffic = find_cell(bench, args.workload)

    import torch

    if check_card and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = (card_line(torch, cell["chips"]) if check_card
            else {"kind": "cpu", "count": 1, "power_limit": "none"})
    loop_cls = loop_class(traffic)
    from zkvm_tpu_torch.ops import kernels
    from zkvm_tpu_torch.utils import metrics

    parts = {"imports": time.monotonic() - t_start}
    loop = loop_cls(config, traffic, args.seed, device)
    loop.setup(parts)
    on_device = not args.trace and any(
        m["source"] == "device_trace"
        for m in metrics_for(bench["end_to_end"], cell["name"]))
    setup_s = time.monotonic() - t_start
    print(json.dumps({"setup_parts_s": parts, "setup_s": setup_s,
                      "card": card}), flush=True)

    trace, records, failed = None, [], 0
    if args.trace:
        from . import trace as tr

        for attempt in range(TRACE_TRIES):
            traced_records = []

            def items(k, out=traced_records):
                for _ in range(k):
                    out.append(loop.item())

            trace = tr.traced(items, traffic["trace_items"], device,
                              kernels, metrics)
            records += traced_records
            failed += sum(r.get("error") is not None for r in traced_records)
            missing = tr.missing_launches(trace)
            print(json.dumps({"traced_window": attempt + 1,
                              "missing_launches": missing,
                              "busy_s": trace.busy_s,
                              "window_s": trace.window_s}), flush=True)
            if missing == 0 and trace.busy_s > 0:
                break
        else:
            print("the traced window missed launches or saw no device time "
                  f"in {TRACE_TRIES} tries", file=sys.stderr)
            return 4
    spans0 = span_totals(metrics)
    window_dev = None
    if on_device:
        from . import trace as tr

        (window, window_s, window_failed), window_dev = tr.device_window(
            lambda: run_window(loop, args.seconds), device, kernels)
        print(json.dumps({"device_window": {
            "busy_s": window_dev.busy_s,
            "missing_launches": window_dev.missing_launches}}), flush=True)
        if window_dev.busy_s <= 0:
            print("the measured window's trace saw no device time",
                  file=sys.stderr)
            return 4
    else:
        window, window_s, window_failed = run_window(loop, args.seconds)
    spans1 = span_totals(metrics)
    spans = {k: (v - spans0.get(k, (0.0, 0))[0], c - spans0.get(k, (0, 0))[1])
             for k, (v, c) in spans1.items()}
    records += window
    failed += window_failed
    peak = (torch.cuda.max_memory_allocated() if check_card else 0)

    if args.trace:
        w = Window(window, window_s, spans, trace)
        values = {}
        for m in metrics_for(bench["per_layer"], cell["name"]):
            v = load_reader(m["name"])(w)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = loop.end_to_end(window, window_s, window_dev)
        e2e["setup_s"] = setup_s
        values = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                  for m in metrics_for(bench["end_to_end"], cell["name"])}

    loop.release()
    if check_card:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks = loop.check(records)
    print(json.dumps({"window_items": len(window), "window_s": window_s,
                      "reference_check_s": time.monotonic() - t_check}),
          flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX stack were loaded: {bad}", file=sys.stderr)
        return 5
    correct = (failed == 0 and bool(window)
               and all(v <= lim for v, lim in checks.values()))
    device_rec = {"platform": "gpu" if check_card else "cpu",
                  "kind": card["kind"], "count": card["count"],
                  "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": values, "device": device_rec}
    if trace is not None:
        device_rec["busy_s"] = trace.busy_s
        device_rec["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(t_start: float) -> int:
    # every cache a run writes stays inside the checkout, at fixed paths
    cache = BENCH_DIR.parent / ".benchcache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    return run(sys.argv[1:], t_start)
