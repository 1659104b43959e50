"""Measuring scripts of the port; nothing on a path imports them."""

from __future__ import annotations

import subprocess

import torch

from ..utils.benches import sync

__all__ = ["card", "print_card", "sync"]


def card() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def print_card(dev: torch.device) -> None:
    """Print `card()` when `dev` is a CUDA device (which raises without a
    card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        print(card(), flush=True)
