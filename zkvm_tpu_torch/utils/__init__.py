"""Utilities: phase metrics and the dryrun circuit."""

from .metrics import Metrics, phase, report

__all__ = ["Metrics", "phase", "report"]
