"""Median host time of a `trainer.step` span over the traced epoch (wait on the staged batch, the step, staging the next batch), ms."""
from perfbench import spans


def read(run):
    return spans.per_step_ms(run, "step")
