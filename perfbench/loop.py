"""The measured window, shared by the drivers: whole units (solves, requests,
steps) back to back from the end of set-up until `seconds` have passed, the
first mix["trace_units"] of them inside the profiler in a traced run."""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench import trace as trace_lib


def kernel1_forwards() -> int:
    """Kernel #1's forwards so far, the program's own counter (a forward
    replayed from a CUDA graph counts on each replay)."""
    from zedo_tpu_torch.ops.kernels import score_kernel

    return score_kernel.launch_counts["fused_score_forward"]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(run, name: str):
    """A span of the benchmark's own on the host clock, ending when the
    device has finished what it was given."""
    t = time.perf_counter()
    yield
    sync(run.device)
    run.spans[name] = run.spans.get(name, 0.0) + time.perf_counter() - t


def measure(run, unit, finish=None) -> list:
    """Call unit(i) for i = 0, 1, ... until run.seconds have passed since
    the first call began, then finish() once (what the program does when a
    batch of work ends, such as the trainer's read of its losses). Each
    unit's (start, end) goes to run.unit_times; its end is where its result
    is in the host's hands. Returns the units' results. A traced run first
    runs mix["trace_units"] units inside the profiler and reduces the trace,
    and then measures its window as an untraced run does."""
    out = []

    def one():
        t = time.perf_counter()
        out.append(unit(len(out)))
        run.unit_times.append((t, time.perf_counter()))

    sync(run.device)
    if run.trace and run.device.type == "cuda":
        tracer = trace_lib.Tracer()
        before = kernel1_forwards()
        with tracer:
            for _ in range(run.mix["trace_units"]):
                one()
        tracer.units = run.traced_units = len(out)
        run.forwards_traced = kernel1_forwards() - before
        run.traced = tracer.reduce()
    start = time.perf_counter()
    run.setup_s = start - run.t0
    while len(out) == run.traced_units or time.perf_counter() - start < run.seconds:
        one()
    if finish is not None:
        finish()
        sync(run.device)
        run.unit_times[-1] = (run.unit_times[-1][0], time.perf_counter())
    run.units = len(out)
    return out


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
