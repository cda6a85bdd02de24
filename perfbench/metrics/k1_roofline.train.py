"""K1's share of its roofline at the training batch, %."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "K1", readers.train_batches(run))
