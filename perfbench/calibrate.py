"""Readings that a cell's comparison limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3 \\
        [--control 3] [--faults 3] [--witness 2]

In one process: for each seed a run of the cell (set-up, a window of
`--seconds` at the cell's own load, the comparison), printing the numbers
compared; then, on the first `--control` seeds, the control (the reference
computed in TF32, put in the program's place); on the first `--witness`
seeds of a training cell, the reference's step losses in float64 beside
the program's and the float32 reference's; then, on the first `--faults`
seeds, each fault of `faults.py` the cell can have, planted under the
timed path.  One JSON line per reading on standard output.  The
benchmark's own runs never call this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _run(bench, workload, seed, seconds, fault=None):
    import contextlib

    import torch

    from perfbench import faults, harness

    run = harness.Run(bench, workload, seed, seconds, False, torch.device("cuda", 0))
    run.t0 = time.perf_counter()
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run.driver.drive(run)
    return run


def _witness(run) -> dict:
    """Each checked step's loss gap, relative, of the program and of the
    float32 reference, each against the reference in float64."""
    import torch

    from perfbench.reference import train as ref_train

    exact = ref_train.three_steps(run, run.batches[:len(run.readings["loss"])],
                                  dtype=torch.float64)["loss"]

    def gaps(losses):
        return [abs(a - b) / abs(b) for a, b in zip(losses, exact)]

    return {"float64_loss": exact, "program_gap": gaps(run.readings["loss"]),
            "reference32_gap": gaps(run.reference["loss"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--witness", type=int, default=0)
    args = p.parse_args(argv)
    from perfbench import harness

    harness.pin_host_threads(harness.benchmark(ROOT), args.workload)
    import torch

    from perfbench import common, faults

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    bench = harness.benchmark(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        run = _run(bench, args.workload, seed, args.seconds)
        line = {"kind": "program", "seed": seed, "correct": run.correct, "failed": run.failed,
                "attempted": run.attempted,
                "readings": {k: v["value"] for k, v in run.checks.items()},
                "end_to_end": run.end_to_end, "setup_s": run.setup_s}
        if hasattr(run, "readings"):
            line["losses"] = {"program": run.readings["loss"], "reference": run.reference["loss"]}
        print(json.dumps(line), flush=True)
        if i < args.control:
            print(json.dumps({"kind": "control", "seed": seed,
                              "readings": run.driver.control(run)}), flush=True)
        if i < args.witness and hasattr(run, "readings"):
            print(json.dumps({"kind": "witness", "seed": seed, **_witness(run)}), flush=True)
        del run
        common.release()
    for seed in seeds[:args.faults]:
        for fault in faults.BY_DRIVER[harness.Run(bench, args.workload, seed, 1, False, "cpu")
                                      .traffic["driver"]]:
            run = _run(bench, args.workload, seed, args.seconds, fault)
            print(json.dumps({"kind": f"fault:{fault}", "seed": seed, "correct": run.correct,
                              "readings": {k: v["value"] for k, v in run.checks.items()}}),
                  flush=True)
            del run
            common.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
