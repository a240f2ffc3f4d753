"""Kernel and graph launches by the host a request (profiler)."""
from perfbench import readers


def read(run):
    return readers.dispatches_per_unit(run)
