"""Model operations of the clips served in the window over the window and the float32 peak, %."""
from perfbench import readers


def read(run):
    return readers.mfu_serve(run)
