"""Rolling per-stage latencies of the serving batcher.

Counterpart of the JAX package's `utils/profiling.py::StageTimer`, with the
same `summary()` keys (read by the queued app's `/metrics`).  The module's
`device_trace` (a `jax.profiler` trace around a region) waits for its
`torch.profiler` twin (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, List

__all__ = ["StageTimer"]


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
