"""K3's share of its roofline at the training batch, %."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "K3", readers.train_batches(run))
