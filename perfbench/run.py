"""Run one cell of BENCHMARK.json once on one NVIDIA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Builds the cell's system from the seed, warms
up every shape its traffic uses (counted in `setup_s`), drives it for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics) and `device`, then `breakdown` and
`checks` (each compared number beside its limit, also printed last on
standard error).  Exits 1 with no result when CUDA or the cards the cell
asks for are missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Keep libraries that can load JAX by themselves from doing so.
os.environ.setdefault("USE_FLAX", "0")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    from perfbench import harness

    bench = harness.benchmark(ROOT)
    cell = {c["name"]: c for c in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 1
    harness.pin_host_threads(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    run = harness.Run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    run.t0 = T0
    run.driver.drive(run)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace_on:
        if not run.trace or run.trace.get("busy_s") is None:
            print("the traced window holds no device event", file=sys.stderr)
            return 1
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
    out = harness.result(run, device)
    print(f"correct: {out['correct']} (failed {run.failed} of {run.attempted})", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
