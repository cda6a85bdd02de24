"""Tracing helpers: named host spans on the profiler's clock, a
`torch.profiler` trace around a region, and the rolling per-stage latencies
of the serving batcher.

Counterpart of the JAX package's `utils/profiling.py`: `device_trace` (a
`jax.profiler` trace there, a Chrome trace of `torch.profiler` here) and
`StageTimer`, with the same `summary()` keys (read by the queued app's
`/metrics`).  `span` is the port's own.

Spans.  `span(name)` opens a named range while a profiler records and
nothing otherwise.  The trainer (`train/trainer.py`) opens these, all on the
calling thread:

  trainer.step         one iteration of `run_epoch`'s loop: the wait on the
                       staged batch, the step, the bookkeeping, then the
                       fetch and staging of the next batch
    trainer.fetch      `next()` on the loader, for the next batch (the
                       first batch's before the loop; in the last step it
                       finds the loader exhausted)
    trainer.stage      `_stage_batch` of the next batch: pinned host copies
                       and the side stream's copies (the first batch's
                       before the loop)
    trainer.forward    per microbatch: the device video, the model, the
                       losses; in an eval step the whole step
    trainer.backward   per microbatch: `.backward()` (the calling thread
                       waits on autograd's device thread throughout)
    trainer.reduce     the gradients' and losses' all-reduce (data parallel)
    trainer.optimizer  the Adam update
  trainer.epoch_sync   the epoch's one fetch of its losses, where the host
                       waits for the card's backlog

and, inside `trainer.forward`, the frozen WavLM prefix
(`train/prefix_graph.py`) opens one span per unit it runs (the front end,
each frozen layer that LayerDrop keeps):

  wavlm.prefix_replay  the unit replayed from its CUDA graph
  wavlm.prefix_eager   the unit run op by op (the first step of a shape)

To see them beside the kernels, wrap `EmotionTrainer.run_epoch` in
`device_trace(dir)`: the Chrome trace it writes holds each span as a CPU
operator on the kernels' clock.  Under Nsight Systems, wrap it in
`torch.autograd.profiler.emit_nvtx()` instead: the same ranges become NVTX
ranges.

A span is a `torch._C._profiler._RecordFunctionFast` range, a private
class, because it records a `cpu_op` range (scope FUNCTION).  The public
`torch.profiler.record_function` opens a user annotation, and with CUDA
activity profiled Kineto adds a device-side `gpu_user_annotation` for it
that stretches from the range's first kernel to its last: a reader that
takes every timed CUDA event for a kernel would count each span as one
and find the card busy under it.  With no profiler active `span` creates
nothing and costs a fraction of a microsecond; a recorded span costs a few
microseconds, several times less than `record_function`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["StageTimer", "device_trace", "span"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager: a `cpu_op` range called `name` while a
    `torch.profiler` session (or `emit_nvtx`) is active, and
    a no-op otherwise.  It keeps no time and no memory of its own."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace a region with `torch.profiler` when `log_dir` is set: host
    activity, and the card's when CUDA is available.  On exit the trace is
    written to `log_dir` as a Chrome trace (`trace_<pid>_<ns>.json`, the
    path the context yields; open it in Perfetto or chrome://tracing).
    The trace holds the `span` ranges opened in the region: around
    `EmotionTrainer.run_epoch` it shows the trainer's phases beside the
    kernels they launch (under Nsight Systems, `torch.autograd.profiler.
    emit_nvtx()` around the same call turns them into NVTX ranges).  With
    an empty `log_dir` it does nothing and yields None."""
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
