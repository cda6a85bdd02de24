"""Measurement entry points of the port: each runs on the card (or raises
without one) and prints one JSON line that names the card.

    python -m multimodalemotionrecognition_torch.bench.attn_tile   # K6 per batch tile, beside K1
    python -m multimodalemotionrecognition_torch.bench.forward     # flagship forward, clips/min
    python -m multimodalemotionrecognition_torch.bench.convergence_gate  # test accuracy after training
                                                                         # (--device cpu: on the CPU)
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from multimodalemotionrecognition_torch.utils.device import card_line, require_device

__all__ = ["card_line", "events_ms", "require_device"]


def events_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Time of one fn() call in ms over `iters` queued calls: CUDA events on
    the card (device time, the host only has to keep the queue filled), the
    host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters
