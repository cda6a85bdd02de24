"""The trainer's `trainer.*` spans (`utils/profiling.py::span`), on the CPU.

Under `torch.profiler` an epoch of `EmotionTrainer.run_epoch` holds one
`trainer.step` per batch with its phases inside it, the first batch's fetch
and staging before the loop and the epoch's one sync after it, all as
`cpu_op` ranges (never user annotations, which Kineto mirrors on the
device).  With no profiler the spans open nothing and change nothing.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodalemotionrecognition_torch.utils import profiling
from tests.test_torch_trainer import _batches, _port_trainer

N = 3
CASES = {"train": (True, 1), "accum2": (True, 2), "eval": (False, 1)}


def _epoch(train: bool, accum: int):
    """A fresh tiny trainer's stage-2 epoch over N batches -> (metrics, parameters)."""
    trainer, state = _port_trainer(grad_accum=accum)
    mask, lrs = trainer.trainable_mask(2), trainer.lr_tree(2, {})
    _, metrics = trainer.run_epoch(state, _batches(N, seed=5), train, mask, lrs)
    return metrics, {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _profiled(train: bool, accum: int):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _epoch(train, accum)
    return got, [e for e in prof.events() if e.name.startswith("trainer.")]


def _inside(span, outer) -> bool:
    return outer[0] <= span[0] and span[1] <= outer[1]


@pytest.mark.parametrize("case", list(CASES))
def test_an_epoch_opens_every_span_once_per_phase_and_nested(case):
    train, accum = CASES[case]
    _, events = _profiled(train, accum)
    assert events and not any(e.is_user_annotation for e in events)
    assert len({e.thread for e in events}) == 1
    spans = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        spans.setdefault(e.name[len("trainer."):], []).append(
            (e.time_range.start, e.time_range.end))
    counts = {k: len(v) for k, v in spans.items()}
    want = {"step": N, "fetch": N + 1, "stage": N, "forward": N * accum, "epoch_sync": 1}
    if train:
        want.update(backward=N * accum, reduce=N, optimizer=N)
    assert counts == want

    steps = spans["step"]
    assert spans["fetch"][0][1] <= spans["stage"][0][0] <= spans["stage"][0][1] <= steps[0][0]
    for k in range(N):  # batch k+1 is fetched (the last fetch finds none) in step k
        assert _inside(spans["fetch"][k + 1], steps[k])
    for k in range(N - 1):  # and staged in step k
        assert _inside(spans["stage"][k + 1], steps[k])
    assert steps[-1][1] <= spans["epoch_sync"][0][0]
    for name in ("forward", "backward", "reduce", "optimizer"):
        for k, step in enumerate(steps):
            inner = [s for s in spans.get(name, []) if _inside(s, step)]
            per_step = accum if name in ("forward", "backward") else 1
            assert len(inner) == (per_step if train or name == "forward" else 0), (name, k)


def test_without_a_profiler_no_range_is_made_and_the_epoch_is_unchanged(monkeypatch):
    (want_metrics, want_params), events = _profiled(True, 1)
    assert events

    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a range was made with no profiler active")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Refused)
    metrics, params = _epoch(True, 1)
    assert metrics == want_metrics
    assert params.keys() == want_params.keys()
    assert all(torch.equal(params[n], want_params[n]) for n in params)
