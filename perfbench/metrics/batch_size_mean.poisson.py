"""Mean rows per batch the batcher formed in the window."""
import statistics

from perfbench import readers


def read(run):
    sizes = readers.stage_ms(run, "batch_size")
    return statistics.fmean(sizes) if sizes else None
