"""Kernel #1's share of its roofline bound in the batch solves."""
from perfbench import readers


def read(run):
    return readers.kernel1_roofline(run)
