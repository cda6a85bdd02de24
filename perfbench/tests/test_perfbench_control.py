"""The control of each cell, on the card: the plain reference computed in
TF32 (the precision below the configurations' float32 with TF32 off), put
in the program's place, has to fail the cell's comparison.  At the cells'
widths, on fewer uploads than a run answers and on the three train steps a
run compares."""

from __future__ import annotations

import pytest

from perfbench import gen, harness
from perfbench.drivers import serve, train
from perfbench.tests.tiny import every_cell

BENCH = every_cell(harness.benchmark())
CELLS = {kind: [c["name"] for c in BENCH["workloads"]
                if harness.Run(BENCH, c["name"], 1, 1.0, False, "cpu").traffic["driver"] == kind]
         for kind in ("serve", "train")}


def _failed(run, readings: dict) -> bool:
    """Whether a number the cell compares reads over its limit."""
    return any(readings[k] > limit for k, limit in run.limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS["serve"])
@pytest.mark.parametrize("seed", [3300000007, 3300000019, 3300000031])
def test_serving_control_fails(card, cell, seed):
    run = harness.Run(BENCH, cell, seed, 1.0, False, card)
    pool = gen.uploads({**run.traffic["uploads"], "pool": 12}, seed)
    run.pool = pool
    run.reference = serve.reference_probs(run, pool, set(range(len(pool))))
    assert _failed(run, serve.control(run))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS["train"])
@pytest.mark.parametrize("seed", [3300000007, 3300000019, 3300000031])
def test_training_control_fails(card, cell, seed):
    from perfbench.reference import train as ref_train

    run = harness.Run(BENCH, cell, seed, 1.0, False, card)
    run.batches = gen.train_batches({**run.traffic["batches"], "pool": 3}, seed)
    run.reference = ref_train.three_steps(run, run.batches)
    assert _failed(run, train.control(run))
