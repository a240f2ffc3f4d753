"""The ControlNet adapter's per-solve OIL tables (its packed weights and
step vectors), milliseconds a solve: the program's Stopwatch phase
"oil_tables" (span zedo.oil.tables); None for a program without it."""
from perfbench import readers


def read(run):
    return readers.span_ms(run, "oil_tables")
