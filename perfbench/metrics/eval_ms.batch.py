"""The evaluation's milliseconds a solve (the benchmark's span around it)."""
from perfbench import readers


def read(run):
    return readers.span_ms(run, "eval")
