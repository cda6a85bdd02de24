"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests.tiny import every_cell

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert Path(harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        per_layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
        for m in per_layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_every_metric_layer_is_one_of_the_layers():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"batcher", "runner", "trainer", "kernels", "model", "device"}


def test_held_back_cells_name_files_that_exist():
    """Every limits file names a cell whose configuration and traffic exist,
    and every per-layer reader has its `read`, in BENCHMARK.json or not."""
    held = every_cell(BENCH)
    assert {w["name"] for w in held["workloads"]} >= set(CELLS)
    for w in held["workloads"]:
        run = harness.Run(held, w["name"], 1, 1.0, False, "cpu")
        assert run.limits and run.config["name"] == w["config"]
        assert run.driver.drive
    for path in (harness.HERE / "metrics").glob("*.py"):
        assert "def read(run)" in path.read_text(), path.name
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_budget_fits_a_full_check_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_every_file_of_a_cell(cell):
    run = harness.Run(BENCH, cell, 1, 1.0, False, "cpu")
    assert run.driver.drive
    assert run.config["name"] == run.cell["config"]
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    assert set(run.limits) <= {"probs_gap", "loss_gap", "loss1_gap", "grad_gap", "change_gap",
                               "change_median_gap"}


def test_a_new_cell_config_traffic_and_metric_are_files_and_entries(tmp_path):
    """Add one of each from a temporary copy: no existing file changes."""
    base = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "wavlm-xattn.json").read_text())
    cfg["name"] = "wavlm-xattn-bf16"
    cfg["model"]["compute_dtype"] = "bfloat16"
    (base / "configs" / "wavlm-xattn-bf16.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "train-stage2.json").read_text())
    traffic["batches"]["batch"] = 32
    (base / "traffic" / "train-stage2-b32.json").write_text(json.dumps(traffic))
    (base / "limits" / "wavlm-xattn-bf16.train-stage2-b32.json").write_text('{"loss1_gap": 0.01}')
    (base / "metrics" / "steps_per_epoch.b32.py").write_text(
        "def read(run):\n    return run.counts.get('traced_steps')\n")
    bench = json.loads(json.dumps(BENCH))
    cell = "wavlm-xattn-bf16.train-stage2-b32"
    bench["configs"].append({"name": "wavlm-xattn-bf16", "source": "x", "reduced": [], "why": "bf16",
                             "file": "perfbench/configs/wavlm-xattn-bf16.json"})
    bench["workloads"].append({"name": cell, "config": "wavlm-xattn-bf16",
                               "traffic": "train-stage2-b32", "chips": 1, "why": "bf16, batch 32"})
    bench["per_layer"].append({"name": "steps_per_epoch.b32", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer",
                               "moves": "train_clips_per_s", "workloads": [cell]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append(cell)
    run = harness.Run(bench, cell, 5, 1.0, True, "cpu", base=base)
    assert run.config["model"]["compute_dtype"] == "bfloat16"
    assert run.traffic["batches"]["batch"] == 32
    assert run.driver.__name__ == "perfbench.drivers.train"
    run.counts["traced_steps"] = 8
    assert harness.read_per_layer(run) == {"steps_per_epoch.b32": {"value": 8.0, "unit": "steps"}}
    run.setup_s, run.end_to_end["train_clips_per_s"] = 20.0, 300.0
    assert set(harness.end_to_end(run)) == {"setup_s", "train_clips_per_s"}
    after = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
