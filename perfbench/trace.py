"""Reduction of a torch.profiler trace of the card to what the per-layer
readers take: the device's operations by name, the union of their
intervals (busy seconds), the host's dispatches, and the idle gaps by what
the host was doing in them.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import torch

# host calls that put work on the device: kernel launches and graph launches
DISPATCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
              "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10


def _start_end(event) -> tuple:
    """(start, end) in seconds of a kineto event, across PyTorch versions."""
    if hasattr(event, "start_ns"):
        start = event.start_ns() * 1e-9
        return start, start + event.duration_ns() * 1e-9
    start = event.start_us() * 1e-6
    return start, start + event.duration_us() * 1e-6


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced window's wall time
    busy_s: float  # the union of the device's operation intervals
    device_ops: dict  # name -> seconds on the device
    dispatches: int  # host launches of kernels and graphs
    idle_gaps: dict  # what the host was doing -> idle seconds of the device
    units: int  # timed units inside the traced window

    def device_seconds(self, *fragments: str) -> float:
        """Seconds of the device operations whose name holds any of
        `fragments`."""
        return sum(s for n, s in self.device_ops.items() if any(f in n for f in fragments))

    def breakdown(self) -> dict:
        def top(d):
            return [[name, seconds] for name, seconds in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_ops), "idle_gaps": top(self.idle_gaps)}


class Tracer:
    """`with tracer: ...` profiles the host and the card; `reduce()` after."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.wall = 0.0
        self.units = 0

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Trace:
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            on = device if e.device_type() == torch.autograd.DeviceType.CUDA else host
            on.append((*_start_end(e), e.name()))
        return summarize(device, host, self.wall, self.units)


def summarize(device: list, host: list, wall: float, units: int) -> Trace:
    """The Trace of (start, end, name) intervals of the device's operations
    and of the host's events over a traced window of `wall` seconds."""
    ops = {}
    for start, end, name in device:
        ops[name] = ops.get(name, 0.0) + (end - start)
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for start, end, _ in sorted(device):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    dispatches = sum(1 for _, _, name in host if name in DISPATCHES)
    return Trace(window_s=wall, busy_s=busy, device_ops=ops, dispatches=dispatches,
                 idle_gaps=_gaps_by_host(gaps, host), units=units)


def _gaps_by_host(gaps: list, host: list) -> dict:
    """Idle seconds of the device by the innermost host event that covers
    each gap's middle ("idle" where none does)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        # the innermost covering event started last among those covering
        for start, end, name in reversed(host[max(0, i - 200):i]):
            if end >= mid:
                best = name
                break
        key = best or "idle"
        out[key] = out.get(key, 0.0) + (b - a)
    return out
