"""OIL's milliseconds a solve (the program's Stopwatch phase "oil")."""
from perfbench import readers


def read(run):
    return readers.span_ms(run, "oil")
