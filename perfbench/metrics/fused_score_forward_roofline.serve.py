"""Kernel #1's share of its roofline bound in serving's requests."""
from perfbench import readers


def read(run):
    return readers.kernel1_roofline(run)
