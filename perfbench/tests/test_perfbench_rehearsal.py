"""CPU rehearsals of a run's control flow at tiny widths, and the faults
`correct` has to catch.  No number here is a device's: the readers of
device metrics find nothing on the CPU and report nothing."""

from __future__ import annotations

import contextlib
import importlib.util
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import faults, harness
from perfbench.tests.tiny import every_cell, tiny_base

SEED = 2**31 + 101
BENCH = every_cell(harness.benchmark())
CELLS = [c["name"] for c in BENCH["workloads"]]
DRIVERS = {c: harness.Run(BENCH, c, 1, 1.0, False, "cpu").traffic["driver"] for c in CELLS}
FAULT_CASES = [(c, f) for c in CELLS for f in faults.BY_DRIVER[DRIVERS[c]]]
READERS = sorted(p.stem for p in (harness.HERE / "metrics").glob("*.py"))
# Readers of the device's trace or of its peak: nothing to read on the CPU.
DEVICE_WORDS = ("roofline", "mfu", "device_idle", "launches")


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"rehearsed_{name}",
                                                  harness.HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_base(tmp_path_factory.mktemp("tiny"))


def _drive(tiny, cell, fault=None, trace=False, seconds=1.0):
    bench, base = tiny
    run = harness.Run(bench, cell, SEED, seconds, trace, torch.device("cpu"), base=base)
    run.t0 = time.perf_counter()
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run.driver.drive(run)
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_no_device_number(tiny, cell):
    run = _drive(tiny, cell, trace=True)
    assert run.correct, run.checks
    assert run.setup_s > 0 and run.attempted > 0 and run.failed == 0
    out = harness.result(run, {"platform": "cpu"})
    assert not [m for m in out["metrics"] if any(w in m for w in DEVICE_WORDS)]
    assert list(out)[-1] == "checks"
    for name in READERS:
        value = _reader(name).read(run)
        if any(w in name for w in DEVICE_WORDS):
            assert value is None, name
        else:
            assert value is None or math.isfinite(value), name
    e2e = harness.end_to_end(run)
    assert "setup_s" in e2e and run.end_to_end
    if cell in [c["name"] for c in harness.benchmark()["workloads"]]:
        assert len(e2e) == 2


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    run = _drive(tiny, cell, fault)
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", [c for c in CELLS if DRIVERS[c] == "train"])
def test_the_unchanged_state_reads_one(tiny, cell):
    run = _drive(tiny, cell, "unchanged")
    changes = [v["value"] for k, v in run.checks.items() if k.startswith("change")]
    assert changes and changes == pytest.approx([1.0] * len(changes))


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         harness.benchmark()["workloads"][0]["name"],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_run_fails_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         harness.benchmark()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()
