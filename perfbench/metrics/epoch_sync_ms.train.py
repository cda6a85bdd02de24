"""Host time of the traced epoch's `trainer.epoch_sync` (its one fetch, waiting for the card's backlog), ms."""
from perfbench import spans


def read(run):
    return spans.sync_ms(run)
