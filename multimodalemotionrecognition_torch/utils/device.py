"""The device an entry point runs on, and the card's own description."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card_line", "require_device"]


def require_device(device, who: str = "") -> torch.device:
    """`device` as a torch.device.  Every entry point of the port runs on the
    card unless its caller passes `device="cpu"`: a CUDA device that is not
    there raises, named after the entry `who`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}): CUDA is not available (pass device='cpu' to run there)"
        )
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` prints them ("cpu"
    for a CPU rehearsal)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[device.index or 0]
