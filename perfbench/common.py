"""Pieces both drivers use: the precision a configuration states, freeing
the program's state before the reference runs, and the reference model
built from the run's seed."""

from __future__ import annotations

import gc

import torch

from perfbench import weights
from perfbench.reference.model import Model


def precision(config: dict, tf32: bool = None) -> None:
    """TF32 on or off for float32 products and convolutions, as the
    configuration states (`"tf32"`), or as `tf32` overrides it."""
    on = bool(config.get("tf32", False)) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def release() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_model(config: dict, seed: int, device) -> Model:
    """The plain model on `device` with the run's weights, made again from the seed."""
    with torch.device("meta"):
        model = Model(config)
    model.to_empty(device=device)
    model.load_state_dict(weights.make(config, seed, device), strict=True)
    return model


def memory_peak(device) -> int:
    """The device's peak of allocated bytes so far (0 off the card)."""
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
