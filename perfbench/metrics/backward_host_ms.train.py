"""Median over the traced steps of the summed host time in `trainer.backward` (the `.backward()` calls), ms."""
from perfbench import spans


def read(run):
    return spans.per_step_ms(run, "backward")
