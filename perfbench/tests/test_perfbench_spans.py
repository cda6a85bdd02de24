"""The readers of the trainer's spans (`spans.py`, `metrics/*.train.py`) on
a hand-built trace, on a traced serving run, and in a CPU rehearsal of the
training cell."""

from __future__ import annotations

import importlib.util
import math
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spans
from perfbench.tests.tiny import tiny_base

HOST_MS = {"step_host_ms.train": 1950.0, "stage_host_ms.train": 150.0,
           "forward_host_ms.train": 450.0, "backward_host_ms.train": 550.0,
           "optimizer_host_ms.train": 300.0, "epoch_sync_ms.train": 300.0}
IDLE = {"idle_in_stage.train": 100.0 / 3, "idle_outside_spans.train": 100.0 / 3}

# Two steps.  The first batch's fetch and stage come before the first step,
# the next batch's inside each step (the last fetch finds none), the
# epoch's sync after the last.  Times in seconds.
SPANS = [("fetch", 0.0, 0.1), ("stage", 0.1, 0.2),
         ("step", 1.0, 3.0), ("forward", 1.1, 1.5), ("backward", 1.5, 2.0),
         ("reduce", 2.0, 2.1), ("optimizer", 2.1, 2.4), ("fetch", 2.5, 2.6), ("stage", 2.6, 2.9),
         ("step", 3.0, 4.9), ("forward", 3.1, 3.6), ("backward", 3.6, 4.2),
         ("reduce", 4.2, 4.3), ("optimizer", 4.3, 4.6), ("fetch", 4.7, 4.8),
         ("epoch_sync", 5.2, 5.5)]
# Idle gaps of 0.1 s: 2.7-2.8 under the stage, 3.2-3.3 under a forward, 5.05-5.15
# under no span.
KERNELS = [("k", 1.2, 2.0), ("k", 1.9, 2.7), ("k", 2.8, 3.2), ("k", 3.3, 5.05), ("k", 5.15, 5.3)]
# Launch calls on the main thread and on autograd's device thread (2).
LAUNCH_CALLS = [("cudaLaunchKernel", 1.2, 1.21, 1), ("cudaLaunchKernelExC", 1.7, 1.71, 2),
                ("cuLaunchKernel", 2.65, 2.66, 1), ("cudaLaunchKernel", 2.45, 2.46, 1),
                ("cudaLaunchKernel", 5.1, 5.11, 1)]


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"spans_{name}",
                                                  harness.HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(cpu_ops, kernels):
    return SimpleNamespace(trace={"cpu_ops": cpu_ops, "kernels": kernels},
                           counts={"traced_steps": 2})


def _train_ops():
    ops = [("aten::mm", 1.2, 1.3, 1)] + LAUNCH_CALLS
    return ops + [(f"trainer.{n}", s, e, 1) for n, s, e in SPANS]


def test_the_entries_name_a_reader_each():
    named = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in {**HOST_MS, **IDLE}:
        m = named[name]
        assert (m["layer"], m["source"], m["moves"]) == ("trainer", "program_span",
                                                         "train_clips_per_s")
        assert m["workloads"] == ["wavlm-xattn.train-stage2"]


@pytest.mark.parametrize("name", sorted({**HOST_MS, **IDLE}))
def test_each_reader_on_a_hand_built_trace(name):
    want = {**HOST_MS, **IDLE}[name]
    assert _reader(name).read(_run(_train_ops(), KERNELS)) == pytest.approx(want)


def test_the_idle_time_and_the_launches_by_phase():
    run = _run(_train_ops(), KERNELS)
    total, by_phase = spans.idle_by_phase(run)
    assert total == pytest.approx(0.3)
    assert {k: v for k, v in by_phase.items() if abs(v) > 1e-12} == pytest.approx(
        {"stage": 0.1, "forward": 0.1, "outside": 0.1})
    assert spans.launches_by_phase(run) == {"forward": 1, "backward": 1, "stage": 1, "step": 1,
                                            "outside": 1}


@pytest.mark.parametrize("name", sorted({**HOST_MS, **IDLE}))
def test_a_traced_serving_run_reads_nothing(name):
    run = _run([("aten::mm", 1.2, 1.3, 1), ("cudaLaunchKernel", 1.2, 1.21, 1)], KERNELS)
    assert _reader(name).read(run) is None
    assert _reader(name).read(SimpleNamespace(trace=None, counts={})) is None


@pytest.mark.parametrize("name", sorted(IDLE))
def test_the_idle_readers_need_kernels(name):
    assert _reader(name).read(_run(_train_ops(), [])) is None


def test_a_rehearsal_of_the_training_cell_reads_every_host_span(tmp_path):
    torch.set_num_threads(2)
    bench, base = tiny_base(tmp_path)
    run = harness.Run(bench, "wavlm-xattn.train-stage2", 2**31 + 7, 1.0, True,
                      torch.device("cpu"), base=base)
    run.t0 = time.perf_counter()
    run.driver.drive(run)
    assert run.correct, run.checks
    for name in HOST_MS:
        value = _reader(name).read(run)
        assert value is not None and math.isfinite(value) and value > 0, name
    metrics = harness.read_per_layer(run)
    assert set(HOST_MS) <= set(metrics) and not set(IDLE) & set(metrics)
