"""The program's own spans (`zedo_tpu_torch.utils.profiling`) as per-layer
numbers: the device time of the operations each `zedo.` span launched, the
device's idle gaps by the span the host was in, and a request's host time
against its wait for the card.

A device operation belongs to the innermost `zedo.` span that holds the host
call which launched it (a kernel launch, a copy, or the `cudaGraphLaunch` of
a graph's kernels), found through kineto's correlation id and never through
times, since the card runs behind the host. An operation whose launch lies
in no span, or is missing from the trace, belongs to OUTSIDE (the caller's
own time). An idle gap belongs to the innermost span over its middle.

The measured window (`loop.measure`, `trace.Tracer`) does not call this
module yet; PERF.md (Open questions) names the additions that would.
"""
from __future__ import annotations

import bisect

import torch

from perfbench import trace as trace_lib

PREFIX = "zedo."
OUTSIDE = "outside"
# the host calls that put work on the device are the CUDA API's
# (cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync, cuLaunchKernel, ...);
# the host's other events are operators (aten::...) and spans, whose ids may
# equal a device operation's correlation id
LAUNCH_PREFIX = "cu"


def kineto_events(prof) -> tuple:
    """(device, host) of a finished torch.profiler.profile: the device's
    operations and the host's events as (start, end, name, correlation id),
    in seconds."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = trace_lib._start_end(e)
        on = device if e.device_type() == torch.autograd.DeviceType.CUDA else host
        on.append((start, end, e.name(), e.correlation_id()))
    return device, host


def _innermost(spans: list, starts: list, t: float) -> str:
    """The name of the innermost span of `spans` ((start, end, name), nested
    or apart, by start and the outer first) that holds `t`, or OUTSIDE."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] >= t:
            return spans[i][2]
    return OUTSIDE


def _merged(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint [start, end]."""
    out = []
    for start, end, *_ in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def by_span(device: list, host: list) -> tuple:
    """(device_by_span, idle_by_span) of kineto_events' lists, in seconds by
    span name or OUTSIDE: the union of the intervals of the operations each
    span launched, and the gaps between the device's operations (those of
    `trace.summarize`) by the span over each gap's middle."""
    spans = sorted(((s, e, n) for s, e, n, _ in host if n.startswith(PREFIX)),
                   key=lambda span: (span[0], -span[1]))
    starts = [s for s, _, _ in spans]
    launched = {c: s for s, _, n, c in host if n.startswith(LAUNCH_PREFIX)}
    # the device's operations, without the device's copies of host scopes
    # (kineto's GPU user annotations) that a span of the user's scope makes
    device = [d for d in device if not d[2].startswith(PREFIX)]
    owned: dict = {}
    for start, end, _, corr in device:
        at = launched.get(corr)
        owner = OUTSIDE if at is None else _innermost(spans, starts, at)
        owned.setdefault(owner, []).append((start, end))
    device_by_span = {k: sum(e - s for s, e in _merged(ops)) for k, ops in owned.items()}
    idle_by_span: dict = {}
    union = _merged(device)
    for (_, a), (b, _) in zip(union, union[1:]):
        owner = _innermost(spans, starts, (a + b) / 2)
        idle_by_span[owner] = idle_by_span.get(owner, 0.0) + b - a
    return device_by_span, idle_by_span


def device_ms(device_by_span: dict, name: str, units: int):
    """The device milliseconds a unit linked to the span `name`, or None."""
    if not units or name not in device_by_span:
        return None
    return device_by_span[name] / units * 1e3


def predict_ms(log: list):
    """(host ms, wait ms) a request over a span log (`profiling.spans()`):
    the mean of `zedo.predict` less its `zedo.predict.d2h_wait`, and the
    mean of that wait; None without a request."""
    requests = {i for i, s in enumerate(log) if s.name == "zedo.predict" and s.end_ns}
    if not requests:
        return None
    total = sum(log[i].end_ns - log[i].start_ns for i in requests)
    wait = sum(s.end_ns - s.start_ns for s in log
               if s.name == "zedo.predict.d2h_wait" and s.parent in requests)
    return (total - wait) / len(requests) * 1e-6, wait / len(requests) * 1e-6
