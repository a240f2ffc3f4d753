"""Input poses solved a second, each with all its hypotheses, over the window."""
from perfbench import readers


def read(run):
    return readers.rate(run)
