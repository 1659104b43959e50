"""Per-phase wall-clock metrics.

The reference's only measurement surface is manual Instant spans printed in
the service layer (merkle-plonk/src/lib.rs:254-338, SURVEY.md section 5.1);
here phase timing is a first-class subsystem: nested context-manager spans
accumulated into a global registry, dumpable as a dict/JSON, plus a device
trace directory viewable in TensorBoard or Perfetto.  Counterpart of
`zkvm_tpu/utils/metrics.py`; its `trace_to` is `torch.profiler`'s trace
here, where the reference's is `jax.profiler`'s.
"""

from __future__ import annotations

import contextlib
import json
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
            yield
        finally:
            dt = time.monotonic() - t0
            self.totals[key] += dt
            self.counts[key] += 1
            self._stack.pop()

    def as_dict(self) -> dict:
        return {k: {"total_s": round(v, 6), "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str | None = None) -> str:
        blob = json.dumps(self.as_dict(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(blob)
        return blob

    def reset(self):
        self.totals.clear()
        self.counts.clear()


GLOBAL = Metrics()


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
    the profiler."""
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
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def trace_to(logdir: str, device="cuda"):
    """Device profiler trace of the enclosed work (`padded_profile`),
    written on exit as a Chrome trace (`*.pt.trace.json`) under `logdir`,
    which TensorBoard or Perfetto opens; on a CUDA device its first
    `PAD_LAUNCHES` kernels are the pad's.  A context manager yielding the
    `torch.profiler.profile` object."""
    from torch.profiler import tensorboard_trace_handler

    return padded_profile(device, tensorboard_trace_handler(logdir))
