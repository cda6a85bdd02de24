"""Median over the traced steps of the summed host time in `trainer.forward` (device video, model, losses per microbatch), ms."""
from perfbench import spans


def read(run):
    return spans.per_step_ms(run, "forward")
