"""The 95th percentile latency of all requests of the window."""
from perfbench import readers


def read(run):
    return readers.latency_ms(run, 95)
