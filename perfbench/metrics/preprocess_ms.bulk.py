"""Median host time of the batcher's stage 1 (payload decode, resample, stacking, staged copy) per batch, ms."""
from perfbench import readers


def read(run):
    return readers.median_or_none(readers.stage_ms(run, "preprocess"))
