"""The traced window: a torch.profiler window over a run of the cell's
items, read into device busy time, kernel times by name, the idle gaps
named by what the host was doing, and the lanes of the port's kernel
launches (counted by the benchmark's own wrappers around the port's
kernel entry points).

The window is the host range `bench/window` opened by the harness; only
device activity inside it counts.  Each run checks its own window: the
port's kernels that the trace shows must be as many as the port's
launch counters (`kernels.LAUNCHES`) counted in it.

`device_window` is the lighter trace of an untraced run's measured
window, for an end-to-end metric read from the device: the card alone is
recorded, so the host pays only the profiler's per-launch cost.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import torch

WINDOW = "bench/window"
# host ranges that name what the host was doing: the harness's own and the
# program's spans, which the traced run mirrors into profiler ranges
RANGE_PREFIXES = ("bench/", "prove/", "service/")
# the port's launch counters and the kernels each launches
KERNELS_OF = {"mont_mul": ("mont_mul_kernel",),
              "mont_pow": ("mont_pow_kernel",),
              "padd": ("padd_kernel",),
              "padd_ilp": ("padd_ilp_kernel",),
              "window_fold": ("window_fold_kernel",),
              "ntt_stages": ("ntt_pass_kernel",),
              "carry_fold": ("carry_fold_kernel",),
              "fold": ("fold_kernel",),
              "hades_permute": ("hades_kernel", "hades_coop_kernel"),
              "field_addsub": ("field_addsub_kernel",),
              "quotient": ("quotient_kernel",)}
_KERNEL_NAME = re.compile(r"([A-Za-z_][A-Za-z0-9_]*_kernel)\b")


def kernel_basename(name: str) -> str:
    """A device op's name without its template and parameter lists: the
    first `*_kernel` identifier, else the name cut at its first '<' or
    '(' (so `void cub::...SortOnesweepKernel<...>(...)` reads
    `cub::...SortOnesweepKernel`)."""
    m = _KERNEL_NAME.search(name)
    if m:
        return m.group(1)
    short = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return short.removeprefix("void ").strip() or name


@dataclass
class Trace:
    """What a traced window read: seconds throughout."""

    window_s: float
    busy_s: float
    items: int
    kernel_s: dict[str, float]      # device op name -> summed seconds
    kernel_n: dict[str, int]        # device op name -> launches
    idle_by_range: dict[str, float]  # innermost host range -> idle seconds
    launches: dict[str, int]        # the port's counters over the window
    lanes: dict[str, list] = field(default_factory=dict)

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the trace."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        try:
            start, end = ev.start_ns(), ev.end_ns()
        except AttributeError:  # older kineto bindings
            start = int(ev.start_us() * 1000)
            end = start + int(ev.duration_us() * 1000)
        out.append((ev.name(), ev.device_type() != DeviceType.CPU, start, end))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, items: int, launches: dict[str, int],
              lanes: dict[str, list]) -> Trace:
    """Read a window from the trace's events (see `_events`)."""
    ranges = [(n, s, e) for n, dev, s, e in events
              if not dev and n.startswith(RANGE_PREFIXES)]
    windows = [(s, e) for n, s, e in ranges if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' "
                           f"ranges, not one")
    w0, w1 = windows[0]
    names = {n for n, _, _ in ranges}
    device = [(n, max(s, w0), min(e, w1)) for n, dev, s, e in events
              if dev and n not in names and e > w0 and s < w1]
    kernel_s, kernel_n = {}, {}
    for n, s, e in device:
        key = kernel_basename(n)
        kernel_s[key] = kernel_s.get(key, 0.0) + (e - s) * 1e-9
        kernel_n[key] = kernel_n.get(key, 0) + 1
    busy = _union([(s, e) for _, s, e in device])
    busy_ns = sum(e - s for s, e in busy)
    # idle time, each piece named by the innermost host range open there
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    inner = [(n, s, e) for n, s, e in ranges if n != WINDOW]
    cuts = sorted({w0, w1} | {x for _, s, e in inner for x in (s, e)
                              if w0 < x < w1})
    idle = {}
    g = 0
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [(e - s, n) for n, s, e in inner if s <= mid < e]
        name = min(open_)[1] if open_ else WINDOW
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        k = g
        while k < len(gaps) and gaps[k][0] < b:
            over = min(b, gaps[k][1]) - max(a, gaps[k][0])
            if over > 0:
                idle[name] = idle.get(name, 0.0) + over * 1e-9
            k += 1
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 items=items, kernel_s=kernel_s, kernel_n=kernel_n,
                 idle_by_range=idle, launches=dict(launches),
                 lanes={k: list(v) for k, v in lanes.items()})


def _missing(launches: dict[str, int], kernel_n: dict[str, int]) -> int:
    seen = counted = 0
    for key, n in launches.items():
        counted += n
        seen += sum(kernel_n.get(k, 0)
                    for k in KERNELS_OF.get(key, (f"{key}_kernel",)))
    return counted - seen


def missing_launches(tr: Trace) -> int:
    """Counted launches of the port's kernels that the trace did not show."""
    return _missing(tr.launches, tr.kernel_n)


PAD_KERNEL = "empty_kernel"  # the probe a window opens with; not the cell's


@dataclass
class DeviceWindow:
    """What `device_window` read: the seconds in which an operation of the
    window ran on the card, and the port's launches the trace missed."""

    busy_s: float
    missing_launches: int


def device_busy(events, launches: dict[str, int]) -> DeviceWindow:
    """The card's busy time over every device event of a CUDA-only trace
    (see `_events`) but the window's opening probes."""
    device = [(n, s, e) for n, dev, s, e in events
              if dev and kernel_basename(n) != PAD_KERNEL]
    kernel_n = {}
    for n, _, _ in device:
        key = kernel_basename(n)
        kernel_n[key] = kernel_n.get(key, 0) + 1
    busy = _union([(s, e) for _, s, e in device])
    return DeviceWindow(busy_s=sum(e - s for s, e in busy) * 1e-9,
                        missing_launches=_missing(launches, kernel_n))


def device_window(run, device, kernels):
    """`run()` under a profiler that records the card alone, opened by 32
    empty launches and closed by a synchronise, so that all the device
    work that `run` starts falls inside it.  Returns `run()`'s result and
    the window's `DeviceWindow`."""
    from torch.profiler import ProfilerActivity, profile

    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):  # a window's first records may drop: pad it
            kernels.empty_launch(1, 32, device)
        torch.cuda.synchronize(device)
        out = run()
        torch.cuda.synchronize(device)
    launches = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    return out, device_busy(_events(prof), launches)


@contextlib.contextmanager
def lane_counters(kernels):
    """Record the lanes of every `padd` launch and the (rows, log n) of
    every `ntt_stages` transform while the block runs: wrappers around the
    port's entry points, which its callers reach as module attributes."""
    lanes = {"padd": [], "ntt_stages": []}
    real_padd, real_ntt = kernels.padd, kernels.ntt_stages

    def padd(p, q, layouts=None):
        lanes["padd"].append(p[0].numel() // p[0].shape[-2])
        return real_padd(p, q, layouts)

    def ntt_stages(x, tw):
        n = x.shape[-1]
        lanes["ntt_stages"].append((x.numel() // (x.shape[-2] * n),
                                    n.bit_length() - 1))
        return real_ntt(x, tw)

    kernels.padd, kernels.ntt_stages = padd, ntt_stages
    try:
        yield lanes
    finally:
        kernels.padd, kernels.ntt_stages = real_padd, real_ntt


@contextlib.contextmanager
def spans_as_ranges(metrics):
    """Mirror the program's spans (`metrics.Metrics.span`) into profiler
    ranges, so that an idle gap can be named by the round it fell in."""
    cls = metrics.Metrics
    real = cls.span

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function(name), real(self, name):
            yield

    cls.span = span
    try:
        yield
    finally:
        cls.span = real


def traced(run_items, n_items: int, device, kernels, metrics) -> Trace:
    """Profile `run_items(n_items)` (which opens its own host ranges) in a
    window opened by 32 empty launches and closed by a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    before = dict(kernels.LAUNCHES)
    with lane_counters(kernels) as lanes, spans_as_ranges(metrics), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        for _ in range(32):  # a window's first records may drop: pad it
            kernels.empty_launch(1, 32, device)
        torch.cuda.synchronize(device)
        with torch.profiler.record_function(WINDOW):
            run_items(n_items)
            torch.cuda.synchronize(device)
    launches = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    return summarize(_events(prof), n_items, launches, lanes)
