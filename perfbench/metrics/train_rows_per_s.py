"""Rows trained a second over the window, to the end of the last step's work."""
from perfbench import readers


def read(run):
    return readers.rate(run)
