"""What every cell shares: finding its files by name, the run's record, the
per-layer readers, the comparison's lines and the result line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix.  The
configuration is `configs/<config>.json`, the mix `traffic/<traffic>.json`
(whose "driver" names the module under `drivers/` that runs it), the
cell's comparison limits `limits/<workload>.json`, and each per-layer
metric `metrics/<metric>.py` (a `read(run)` that returns a number, or None
when the run holds nothing for it).  Adding a cell, configuration, mix or
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalemotionrecognition_tpu")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def pin_host_threads(bench: dict, workload: str, base: Path = HERE) -> None:
    """Set OMP_NUM_THREADS to the `host_threads` that the cell's
    configuration states, if it states one.  Call it before torch or numpy
    is imported: their thread pools read it once."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload in cells:
        n = _json(base / "configs" / f"{cells[workload]['config']}.json").get("host_threads")
        if n is not None:
            os.environ["OMP_NUM_THREADS"] = str(int(n))


class Run:
    """One run of one cell: its inputs, and what the driver records for the
    result line and the readers."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device, base: Path = HERE):
        cells = {c["name"]: c for c in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.bench = bench
        self.cell = cells[workload]
        self.base = base
        self.config = _json(base / "configs" / f"{self.cell['config']}.json")
        self.traffic = _json(base / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = _json(base / "limits" / f"{workload}.json")
        self.seed, self.seconds, self.trace_on, self.device = int(seed), seconds, trace, device
        # Filled by the driver.
        self.setup_s: Optional[float] = None
        self.attempted = self.failed = 0
        self.end_to_end: dict = {}
        self.checks: dict = {}
        self.memory_peak_bytes = 0
        self.trace: Optional[dict] = None
        self.counts: dict = {}
        self.timer = None

    @property
    def driver(self):
        return importlib.import_module(f"perfbench.drivers.{self.traffic['driver']}")

    def geometry(self) -> dict:
        from perfbench.reference.model import WAVLM_BASE

        return {**WAVLM_BASE, **self.config.get("wavlm", {})}

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit (limits/<workload>.json)."""
        value = float(value)
        if value != value or value == float("inf"):
            value = 1e30  # no reading: a number that fails any limit
        self.checks[name] = {"value": value, "limit": float(self.limits[name])}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def _cell_metrics(run: Run, kind: str) -> list:
    name = run.cell["name"]
    return [m for m in run.bench[kind] if name in m.get("workloads", [name])]


def read_per_layer(run: Run) -> dict:
    """Each per-layer metric of the cell by its reader; None drops it."""
    out = {}
    for m in _cell_metrics(run, "per_layer"):
        path = run.base / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{m['name']}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(run: Run) -> dict:
    out = {}
    for m in _cell_metrics(run, "end_to_end"):
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = run.end_to_end.get(m["name"])
        if value is None:
            raise RuntimeError(f"{run.cell['name']}: the driver measured no {m['name']}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def result(run: Run, device_info: dict) -> dict:
    metrics = read_per_layer(run) if run.trace_on else end_to_end(run)
    out = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device_info}
    if run.trace_on and run.trace and run.trace.get("busy_s") is not None:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = run.checks
    return out
