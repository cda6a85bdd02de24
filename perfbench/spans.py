"""The trainer's spans in a traced run, and the card's idle time under them.

The port's trainer opens `trainer.*` ranges around its phases
(`multimodalemotionrecognition_torch/utils/profiling.py::span`: step, and
inside it fetch, stage, forward, backward, reduce and optimizer; the first
batch's fetch and stage before the first step; epoch_sync after the last).
They are CPU operators of the profile, on the kernels' clock, so
`trace.reduce` keeps them in `cpu_ops`.  Each function returns None when
the run holds no such span (a serving cell, or a program without them);
the idle time also needs kernels, which a CPU run has none of.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

PREFIX = "trainer."
# Runtime and driver calls that launch a kernel.
LAUNCHES = ("cudaLaunch", "cuLaunch")


def spans(run):
    """-> [(phase, start_s, end_s)] of the traced epoch by start, the prefix
    cut off; None without any."""
    if not run.trace:
        return None
    out = sorted(((name[len(PREFIX):], s, e) for name, s, e, _ in run.trace["cpu_ops"]
                  if name.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))
    return out or None


def per_step_ms(run, phase: str):
    """-> the median over the traced steps of the time of `phase` spans
    inside each `trainer.step` (for "step", the step's own), ms."""
    got = spans(run)
    steps = [(s, e) for name, s, e in got or () if name == "step"]
    if not steps:
        return None
    if phase == "step":
        return 1e3 * statistics.median(e - s for s, e in steps)
    inner = [(s, e) for name, s, e in got if name == phase]
    return 1e3 * statistics.median(
        sum(e - s for s, e in inner if s0 <= s and e <= e0) for s0, e0 in steps)


def sync_ms(run):
    """-> the traced epoch's `trainer.epoch_sync` time, ms."""
    got = [e - s for name, s, e in spans(run) or () if name == "epoch_sync"]
    return 1e3 * sum(got) if got else None


def _pieces(nested) -> list:
    """Properly nested spans -> disjoint (start, end, phase) pieces, each
    instant under its innermost span ("step" pieces are its self time)."""
    out, stack, t = [], [], None
    for name, s, e in nested:
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            out.append((t, top[2], top[0]))
            t = top[2]
        if stack:
            out.append((t, s, stack[-1][0]))
        stack.append((name, s, e))
        t = s
    while stack:
        top = stack.pop()
        out.append((t, top[2], top[0]))
        t = top[2]
    return [p for p in out if p[1] > p[0]]


def _idle(kernels) -> list:
    """The gaps in the union of kernel intervals, from the first kernel's
    start to the last one's end, in order."""
    gaps, end = [], None
    for s, e in sorted((s, e) for _, s, e in kernels):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_phase(run):
    """-> (the card's idle seconds, {phase: the idle seconds under it as the
    innermost span, "outside" under none}); None without spans or kernels."""
    got = spans(run)
    if got is None or not run.trace["kernels"]:
        return None
    gaps = _idle(run.trace["kernels"])
    total = sum(e - s for s, e in gaps)
    out, i = defaultdict(float), 0
    for a, b, name in _pieces(got):
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            out[name] += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    out["outside"] = total - sum(out.values())
    return total, dict(out)


def idle_share(run, phase: str):
    """-> the share of the card's idle time under `phase` as the innermost
    span ("outside": under no span), %."""
    got = idle_by_phase(run)
    if got is None or not got[0]:
        return None
    total, by_phase = got
    return 100.0 * by_phase.get(phase, 0.0) / total


def launches_by_phase(run):
    """-> {phase: the kernel launch calls (any thread) that start under it
    as the innermost span, "outside" under none}; None without spans."""
    got = spans(run)
    if got is None:
        return None
    pieces = _pieces(got)
    starts = [p[0] for p in pieces]
    out = defaultdict(int)
    for name, s, _, _ in run.trace["cpu_ops"]:
        if name.startswith(LAUNCHES):
            k = bisect.bisect_right(starts, s) - 1
            out[pieces[k][2] if k >= 0 and s < pieces[k][1] else "outside"] += 1
    return dict(out)
