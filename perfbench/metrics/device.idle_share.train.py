"""The share of the traced window in which no operation ran on the card."""
from perfbench import readers


def read(run):
    return readers.idle_share(run)
