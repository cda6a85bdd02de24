"""Device kernels launched in the traced span per batch whose forward ended in it."""
from perfbench import readers


def read(run):
    n, batches = readers.launches(run), readers.traced_batches(run)
    return n / len(batches) if n is not None and batches else None
