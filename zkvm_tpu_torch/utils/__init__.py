"""Utilities: phase metrics, device traces and the dryrun circuit."""

from .metrics import Metrics, phase, report, trace_to

__all__ = ["Metrics", "phase", "report", "trace_to"]
