"""Per-phase wall-clock metrics.

The reference's only measurement surface is manual Instant spans printed in
the service layer (merkle-plonk/src/lib.rs:254-338, SURVEY.md section 5.1);
here phase timing is a first-class subsystem: nested context-manager spans
accumulated into a global registry, plus a device trace directory viewable
in TensorBoard or Perfetto.  Counterpart of `zkvm_tpu/utils/metrics.py`;
its `trace_to` is `torch.profiler`'s trace here, where the reference's is
`jax.profiler`'s.

A span's key is the `/`-joined stack of the spans open on entry.  Inside a
`padded_profile` (or `trace_to`) window every span is also a profiler range
of its own name, on the clock of the kernels it launched; outside one a
span reads the host clock alone.  Garbage collection on the thread that
imported this module is the span `prove/gc`, nested in whatever span the
pause interrupted.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import defaultdict

import torch


class Metrics:
    """Accumulates named span durations (seconds) and counts."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = time.monotonic()
        try:
            if _ranges:
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            dt = time.monotonic() - t0
            self.totals[key] += dt
            self.counts[key] += 1
            self._stack.pop()

    def as_dict(self) -> dict:
        return {k: {"total_s": round(v, 6), "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


GLOBAL = Metrics()

# whether a span also opens a profiler range: on inside `padded_profile`
# alone, so that a profiler opened elsewhere (a card-only window counts
# every device event as work) sees no range of the program's
_ranges = False


def _gc_span(phase: str, info: dict) -> None:
    """`gc.callbacks` hook: a collection on the importing thread is the
    span `prove/gc` of `GLOBAL` (the registry's stack is not thread-safe).
    Entered through the class's `span`, so that a replacement of
    `Metrics.span` sees the pauses too."""
    global _gc_open
    if threading.get_ident() != _GC_THREAD:
        return
    if phase == "start":
        _gc_open = GLOBAL.span("prove/gc")
        _gc_open.__enter__()
    elif _gc_open is not None:
        opened, _gc_open = _gc_open, None
        opened.__exit__(None, None, None)


_GC_THREAD = threading.get_ident()
_gc_open = None
# one hook a process: a reload replaces the hook an earlier import installed
gc.callbacks[:] = [cb for cb in gc.callbacks
                   if (getattr(cb, "__module__", None),
                       getattr(cb, "__qualname__", None))
                   != (__name__, _gc_span.__qualname__)]
gc.callbacks.append(_gc_span)


def phase(name: str):
    """Global convenience span: `with metrics.phase("prove/round3"): ...`."""
    return GLOBAL.span(name)


def report() -> dict:
    return GLOBAL.as_dict()


# In a long process torch.profiler drops the first kernel records of a
# window (seen on an H100, late in `chip_smoke.py`: a window of a warm
# flagship prove saw 746 of its 756 launches; a fresh process drops none),
# so a CUDA window opens with this many launches of the empty probe kernel
# (`kernels.empty_launch`, no wrapper counts it) for the drop to fall on.
PAD_LAUNCHES = 32
PAD_KERNEL = "empty_kernel"  # the pad's rows, for a reader to leave out


@contextlib.contextmanager
def padded_profile(device="cuda", on_trace_ready=None):
    """A `torch.profiler.profile` window over the enclosed work; yields the
    profile object.  On a CUDA device it records the host and the card: the
    window opens with `PAD_LAUNCHES` empty launches, and the card is
    synchronised after them and before the window closes, so that the
    enclosed launches fall inside it; a CUDA device without a card raises.
    `device="cpu"` records the host alone.  `on_trace_ready` is passed to
    the profiler.  While the window is open, every span of this module is
    also a profiler range of its own name."""
    global _ranges
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"padded_profile: unsupported device {dev}")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        from ..ops import kernels

        torch.cuda.synchronize(dev)  # raises without a card
        kernels.build()
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=on_trace_ready) as prof:
        if dev.type == "cuda":
            for _ in range(PAD_LAUNCHES):
                kernels.empty_launch(1, 32, dev)
            torch.cuda.synchronize(dev)
        outer, _ranges = _ranges, True
        try:
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            _ranges = outer


def trace_to(logdir: str, device="cuda"):
    """Device profiler trace of the enclosed work (`padded_profile`),
    written on exit as a Chrome trace (`*.pt.trace.json`) under `logdir`,
    which TensorBoard or Perfetto opens; on a CUDA device its first
    `PAD_LAUNCHES` kernels are the pad's.  A context manager yielding the
    `torch.profiler.profile` object."""
    from torch.profiler import tensorboard_trace_handler

    return padded_profile(device, tensorboard_trace_handler(logdir))
