"""Model operations a second over the card's peak in the configuration's precision."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
