"""A tiny copy of the benchmark's files for CPU rehearsals: the same cells,
drivers and readers over small WavLM widths, short windows and small pools."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import harness

TINY_WAVLM = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
              "intermediate_size": 96, "conv_dim": [32] * 7, "num_buckets": 32,
              "max_bucket_distance": 64, "num_conv_pos_embeddings": 16,
              "num_conv_pos_embedding_groups": 4, "fused_attention": True, "fused_conv": True}


def every_cell(bench: dict) -> dict:
    """BENCHMARK.json with a cell added for each limits file it does not name
    (`limits/<config>.<traffic>.json`), so that the CPU rehearsals cover
    every driver, configuration and traffic file the harness holds."""
    bench = json.loads(json.dumps(bench))
    cells = {c["name"] for c in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for path in sorted((harness.HERE / "limits").glob("*.json")):
        name = path.stem
        if name in cells:
            continue
        config, traffic = name.split(".", 1)
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "not in BENCHMARK.json"})
        if config not in configs:
            configs.add(config)
            bench["configs"].append({"name": config, "file": f"perfbench/configs/{config}.json"})
    return bench


def tiny_base(tmp: Path) -> tuple:
    """-> (the benchmark with every cell of `every_cell`, a base directory
    holding tiny configs, traffic and limits)."""
    base = tmp / "perfbench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"),
                    dirs_exist_ok=True)
    for path in (base / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if cfg["model"].get("use_wavlm"):
            cfg["wavlm"] = {**cfg.get("wavlm", {}), **TINY_WAVLM}
        path.write_text(json.dumps(cfg))
    for path in (base / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if "uploads" in t:
            t["uploads"]["pool"] = 6
            t["grace_seconds"] = 30
            t["trace_seconds"] = 0.3
            if t["arrivals"]["kind"] == "closed":
                t["arrivals"]["clients"] = 3
            else:
                t["arrivals"]["rate"] = 4.0
        else:
            t["batches"].update(pool=4, batch=2)
            t["epoch_batches"] = 3
        path.write_text(json.dumps(t))
    return every_cell(harness.benchmark()), base
