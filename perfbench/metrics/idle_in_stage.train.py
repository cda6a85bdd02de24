"""Share of the card's idle time in the traced epoch (gaps between its first and last kernel) that lies under a `trainer.stage` span, %."""
from perfbench import spans


def read(run):
    return spans.idle_share(run, "stage")
