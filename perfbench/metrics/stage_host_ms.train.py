"""Median over the traced steps of the host time in `trainer.stage` (the next batch's pinned copies and side-stream copies), ms."""
from perfbench import spans


def read(run):
    return spans.per_step_ms(run, "stage")
