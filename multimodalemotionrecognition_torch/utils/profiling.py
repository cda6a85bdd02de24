"""Tracing helpers: a `torch.profiler` trace around a region, and the
rolling per-stage latencies of the serving batcher.

Counterpart of the JAX package's `utils/profiling.py`: `device_trace` (a
`jax.profiler` trace there, a Chrome trace of `torch.profiler` here) and
`StageTimer`, with the same `summary()` keys (read by the queued app's
`/metrics`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["StageTimer", "device_trace"]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace a region with `torch.profiler` when `log_dir` is set: host
    activity, and the card's when CUDA is available.  On exit the trace is
    written to `log_dir` as a Chrome trace (`trace_<pid>_<ns>.json`, the
    path the context yields; open it in Perfetto or chrome://tracing).
    With an empty `log_dir` it does nothing and yields None."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


class StageTimer:
    """Rolling per-stage latency stats (ms), the last `window` of each stage."""

    def __init__(self, window: int = 128):
        self._samples: Dict[str, deque] = {}
        self.window = window

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1000.0)

    def record(self, name: str, ms: float) -> None:
        self._samples.setdefault(name, deque(maxlen=self.window)).append(ms)

    def samples(self, name: str) -> List[float]:
        """The retained values of one stage, oldest first."""
        return list(self._samples.get(name, ()))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, values in self._samples.items():
            if not values:
                continue
            ordered = sorted(values)
            out[name] = {
                "count": len(values),
                "p50_ms": round(ordered[len(ordered) // 2], 2),
                "p95_ms": round(ordered[min(len(ordered) - 1, int(len(ordered) * 0.95))], 2),
                "mean_ms": round(sum(values) / len(values), 2),
            }
        return out
