"""Per-phase wall-clock metrics.

The reference's only measurement surface is manual Instant spans printed in
the service layer (merkle-plonk/src/lib.rs:254-338, SURVEY.md section 5.1);
here phase timing is a first-class subsystem: nested context-manager spans
accumulated into a global registry, dumpable as a dict/JSON.  Copy of
`zkvm_tpu/utils/metrics.py` without its JAX profiler trace (`trace_to`); a
device trace of the port is `torch.profiler`'s.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


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

