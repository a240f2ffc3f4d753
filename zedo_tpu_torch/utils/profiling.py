"""Profiling hooks.

Port of zedo_tpu/utils/profiling.py on torch.profiler:

- `trace(logdir)`: a torch.profiler capture of the host and, where there is
  one, the card; written to `logdir/trace.json` (Chrome trace format, open
  it in chrome://tracing or Perfetto).
- `annotate(name)`: a named span in that trace (record_function).
- `Stopwatch`: phase wall-clock aggregation with a one-line report. It
  reads the host clock: a phase that launches device work ends with a
  `torch.cuda.synchronize()` of its own if its time is to include that work.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: `with trace('/tmp/trace'): run()`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return record_function(name)


class Stopwatch:
    """Named phase timers: `with sw.phase('oil'): ...`; `print(sw.report())`."""

    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"{name}: {t:.3f}s ({t / total * 100:.1f}%, n={self.counts[name]})"
            for name, t in self.totals.items()
        ]
        return " | ".join(lines)
