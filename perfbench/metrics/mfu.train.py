"""Model operations of the window's train steps (forward, and twice the forward where the backward goes) over the window and the float32 peak, %."""
from perfbench import readers


def read(run):
    return readers.mfu_train(run)
