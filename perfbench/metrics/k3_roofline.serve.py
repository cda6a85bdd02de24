"""K3's share of its roofline at the served buckets, %."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "K3", readers.serve_batches(run))
