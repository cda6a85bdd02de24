"""Device kernels launched in the traced epoch per train step."""
from perfbench import readers


def read(run):
    n, steps = readers.launches(run), run.counts.get("traced_steps")
    return n / steps if n is not None and steps else None
