"""Share of the traced span in which no kernel ran on the card, %."""
from perfbench import readers


def read(run):
    return readers.idle_percent(run)
