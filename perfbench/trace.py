"""A bounded device trace of a steady sub-window, and what is read from it.

`Session` runs `torch.profiler` (host and CUDA activity) between `start()`
and `stop()`, both after a device synchronise, and keeps the host's wall
clock of that span.  `reduce` turns the profile into plain data: every
device kernel (name, start, end in seconds on the trace's clock), the CPU
operators (name, start, end, thread), the span's length, the device's busy
time (the union of kernel intervals), the kernel-time table and the longest
idle gaps named by what the host was running in them.  A profile that holds
no device event at all is reported as empty: its readers find nothing.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

GAPS = 10
OPS = 10


class Session:
    def __init__(self):
        self.prof = None
        self.wall_s = None
        self._t0 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)


def _short(name: str) -> str:
    """A kernel's name without namespaces, return type, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    return name.split("(")[0].split("<")[0].split("::")[-1][:80]


def _union(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def reduce(session: Session) -> dict:
    """-> {"kernels": [(name, start_s, end_s)], "cpu_ops": [(name, start_s,
    end_s, thread)], "window_s", "busy_s", "device_ops", "idle_gaps"}; with
    no device event "kernels" is empty and "busy_s" None."""
    from torch.autograd import DeviceType

    kernels, cpu_ops = [], []
    for ev in session.prof.events():
        rng = ev.time_range
        span = (rng.start / 1e6, rng.end / 1e6)
        if ev.device_type == DeviceType.CUDA:
            if rng.end > rng.start and "Memcpy" not in ev.name and "Memset" not in ev.name:
                kernels.append((ev.name, *span))
        elif ev.device_type == DeviceType.CPU:
            cpu_ops.append((ev.name, *span, ev.thread))
    out = {"kernels": kernels, "cpu_ops": cpu_ops, "window_s": session.wall_s,
           "busy_s": None, "device_ops": [], "idle_gaps": []}
    if not kernels:
        return out
    out["busy_s"] = _union((s, e) for _, s, e in kernels)
    by_name = defaultdict(float)
    for name, s, e in kernels:
        by_name[_short(name)] += e - s
    out["device_ops"] = [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])][:OPS]
    out["idle_gaps"] = _gaps(kernels, cpu_ops)
    return out


def _gaps(kernels, cpu_ops):
    """The longest gaps between device work, each named by the innermost
    host operator that covered its midpoint (on any thread)."""
    spans = sorted((s, e) for _, s, e in kernels)
    gaps, end = [], spans[0][1]
    for s, e in spans[1:]:
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, e)
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:GAPS]:
        mid = 0.5 * (s + e)
        covering = [(oe - os_, name) for name, os_, oe, _ in cpu_ops if os_ <= mid <= oe]
        name = min(covering)[1] if covering else "no host operator"
        out.append([name, length])
    return out


def kernel_time(trace: dict, needles) -> tuple:
    """-> (device seconds of the kernels whose name holds any of `needles`,
    their launch count)."""
    hits = [e - s for name, s, e in trace["kernels"] if any(n in name for n in needles)]
    return sum(hits), len(hits)
