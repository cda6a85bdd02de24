"""Median host time of the batcher's stage 2 (the runner's forward in its executor thread, device to host) per batch, ms."""
from perfbench import readers


def read(run):
    return readers.median_or_none(readers.stage_ms(run, "infer"))
