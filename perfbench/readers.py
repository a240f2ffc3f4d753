"""What the metric readers of metrics/ share: each reads one number from a
run's units, spans, counters or trace, or None where the run has nothing
for it to read."""
from __future__ import annotations

import numpy as np

from perfbench import roofline

# kernel #1's kernels by name in the device trace (csrc/score_mlp.cu{,h})
KERNEL1 = ("wgmma_layer", "dense_layer", "pad_input")


def window(run, values: list):
    """The sum of the window's values a unit over the time from its first
    unit's start to its last unit's end (a traced run's profiled units come
    before its window and are left out)."""
    k = run.traced_units
    times = run.unit_times[k:]
    if not times:
        return None
    return sum(values[k:]) / (times[-1][1] - times[0][0])


def rate(run):
    """Work done a second over the window."""
    return window(run, run.unit_work)


def latency_ms(run, q: float):
    return float(np.percentile(run.latencies_ms, q)) if run.latencies_ms else None


def span_ms(run, name: str):
    """A span's milliseconds a unit of the window (traced runs time them)."""
    if name not in run.spans or not run.units:
        return None
    return run.spans[name] / run.units * 1e3


def kernel1_roofline(run):
    """Kernel #1's least time a forward (roofline.kernel_bound_s) over its
    device time a forward in the trace, in %."""
    if run.traced is None or not run.forwards_traced:
        return None
    seconds = run.traced.device_seconds(*KERNEL1)
    if seconds <= 0:
        return None
    bound, _ = roofline.kernel_bound_s(run.rows_per_forward, run.config["model"])
    return 100.0 * bound / (seconds / run.forwards_traced)


def dispatches_per_unit(run):
    if run.traced is None or not run.traced.units:
        return None
    return run.traced.dispatches / run.traced.units


def idle_share(run):
    if run.traced is None or run.traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.traced.busy_s / run.traced.window_s)


def mfu(run):
    """Model operations a second over the window, as a share of the card's
    peak in the configuration's precision, in %."""
    flops = window(run, run.unit_flops)
    if flops is None or run.device.type != "cuda":
        return None
    return 100.0 * flops / roofline.PEAK_FLOPS[run.peak]
