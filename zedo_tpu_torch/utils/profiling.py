"""Profiling hooks.

Port of zedo_tpu/utils/profiling.py on torch.profiler:

- `trace(logdir)`: a torch.profiler capture of the host and, where there is
  one, the card; written to `logdir/trace.json` (Chrome trace format, open
  it in chrome://tracing or Perfetto).
- `annotate(name)`: the port's span. The program opens one at each layer
  boundary (`zedo.predict`, `zedo.solve`, `zedo.ipo`, `zedo.oil`,
  `zedo.oil.tables`, `zedo.evaluate`, `zedo.capture`, ...), a handful a
  solve or request and never inside a step loop. A span has two sinks, each switched by one
  module-level flag:
  - the device trace: while a torch profiler is active, the span is a
    record function `name`, so it lies in the kineto trace on the
    profiler's own clock, beside the device operations it launched (and in
    `trace()`'s Chrome trace). It is recorded as an operator's scope, not as
    `torch.profiler.record_function`'s user scope: kineto copies a user
    scope onto the device's timeline as an event of the device, which
    whoever adds up the device's operations would count as device work;
  - memory: inside `recording()`, the span is appended to a log of at most
    MAX_EVENTS spans (`spans()`; `clear()` empties it): its name, start and
    end on `time.perf_counter_ns`'s clock, the index of its parent in the
    log and its unit. A span opened outside any other starts a new unit,
    and the spans inside it share its unit id (all the spans of one
    `predict` call carry that request's id). Spans past MAX_EVENTS are not
    logged.
  With both sinks off, a span is one call and two global reads. The log
  serves one thread: spans of several threads would nest wrongly.
- `Stopwatch`: phase wall-clock aggregation with a one-line report, on
  `time.perf_counter`'s clock. It reads the host clock: a phase that
  launches device work ends with a `torch.cuda.synchronize()` of its own if
  its time is to include that work, as `phase(stopwatch, ...)`'s do.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import OrderedDict
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import ProfilerActivity, profile

# spans the in-memory log holds; later spans are not logged
MAX_EVENTS = 65536

_RECORDING = False
_LOG: list = []  # [name, start_ns, end_ns, parent, unit] a span, in the order they opened
_OPEN: list = []  # (index, entry) of the logged spans open now, innermost last
_UNITS = itertools.count()
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int  # 0 while the span is open
    parent: int  # index of the enclosing span in the log, -1 for none
    unit: int  # the id shared by the spans under one outermost span


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


class _Span:
    __slots__ = ("name", "function", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.function = self.entry = None
        if _profiler._is_profiler_enabled:
            self.function = torch._C._profiler._RecordFunctionFast(self.name)
            self.function.__enter__()
        if _RECORDING and len(_LOG) < MAX_EVENTS:
            parent, above = _OPEN[-1] if _OPEN else (-1, None)
            unit = next(_UNITS) if above is None else above[4]
            self.entry = [self.name, time.perf_counter_ns(), 0, parent, unit]
            _OPEN.append((len(_LOG), self.entry))
            _LOG.append(self.entry)
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[2] = time.perf_counter_ns()
            if _OPEN and _OPEN[-1][1] is self.entry:
                _OPEN.pop()
        if self.function is not None:
            self.function.__exit__(*exc)
        return False


@contextlib.contextmanager
def phase(stopwatch, name: str, device: torch.device, span: str = None):
    """The span `span` (default `zedo.<name>`); with a stopwatch, also its
    phase `name`, which ends when the device has finished its work."""
    with annotate(span or "zedo." + name):
        if stopwatch is None:
            yield
            return
        with stopwatch.phase(name):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)


def annotate(name: str):
    """The span `name` (see the module docstring): `with annotate('zedo.x'):`."""
    if _RECORDING or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Spans opened inside are logged in memory (`spans()`)."""
    global _RECORDING
    before, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = before


def spans() -> list:
    """The logged spans (`Span`), in the order they opened."""
    return [Span(*entry) for entry in _LOG]


def clear() -> None:
    """Empty the log (spans open now are logged no more)."""
    _LOG.clear()
    _OPEN.clear()


class Stopwatch:
    """Named phase timers: `with sw.phase('oil'): ...`; `print(sw.report())`."""

    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"{name}: {t:.3f}s ({t / total * 100:.1f}%, n={self.counts[name]})"
            for name, t in self.totals.items()
        ]
        return " | ".join(lines)
