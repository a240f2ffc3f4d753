"""Seconds from process start to the first timed unit."""


def read(run):
    return run.setup_s
