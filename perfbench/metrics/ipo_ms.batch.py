"""IPO's milliseconds a solve (the program's Stopwatch phase "ipo")."""
from perfbench import readers


def read(run):
    return readers.span_ms(run, "ipo")
