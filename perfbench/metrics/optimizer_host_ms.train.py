"""Median over the traced steps of the host time in `trainer.optimizer` (the Adam update), ms."""
from perfbench import spans


def read(run):
    return spans.per_step_ms(run, "optimizer")
