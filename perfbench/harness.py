"""The harness: finds a cell's configuration, traffic mix, driver, limits and
metric readers by the names in BENCHMARK.json, runs the driver, reads the
metrics and decides `correct`.

    configs   perfbench/configs/<config>.json     (the `file` of BENCHMARK.json)
    mixes     perfbench/mixes/<traffic>.json      its "driver" names a driver
    drivers   perfbench/drivers/<driver>.py       run(run) -> Outcome
    limits    perfbench/limits/<workload>.json    {number: limit} of `correct`
    readers   perfbench/metrics/<metric>.py       read(run) -> value or None

A cell's end-to-end metrics are those whose `workloads` name it, or that
have no `workloads`; its per-layer metrics are those whose `workloads` name
it, or that have none and move one of its end-to-end metrics.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded where the port is measured
FORBIDDEN = ("jax", "jaxlib", "flax", "zedo_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file of the benchmark's, under a name of its own."""
    name = "perfbench._by_name." + str(path.relative_to(HERE)).replace("/", ".")[:-3]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; the workloads are {sorted(by_name)}")
    w = by_name[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return Cell(workload=w, config=load_json(ROOT / entry["file"]),
                mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


@dataclasses.dataclass
class Run:
    """What a driver is given and what it leaves for the readers."""

    name: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float  # process start, on time.perf_counter's clock
    setup_s: float = 0.0
    units: int = 0  # solves, requests or steps completed in the window
    unit_times: list = dataclasses.field(default_factory=list)  # (start, end) a unit
    unit_work: list = dataclasses.field(default_factory=list)  # poses or rows a unit
    unit_flops: list = dataclasses.field(default_factory=list)  # model operations a unit
    latencies_ms: list = dataclasses.field(default_factory=list)
    peak: str = "bf16"  # the precision whose peak the products are held to
    spans: dict = dataclasses.field(default_factory=dict)  # name -> seconds
    traced: object = None  # trace.Trace of the first units of the window
    traced_units: int = 0
    forwards_traced: int = 0  # kernel #1 forwards inside the traced units
    rows_per_forward: int = 0  # rows kernel #1 is handed a forward
    failed: int = 0


@dataclasses.dataclass
class Outcome:
    """A driver's result: `check()` compares what the window produced with
    the reference after the window, the program's state freed."""

    check: Callable[[], dict]
    memory_peak_bytes: int
    # the same numbers with something else in the program's place, by name:
    # "control", the reference in the precision below the configuration's,
    # and planted faults (perfbench.control reads them)
    controls: dict = dataclasses.field(default_factory=dict)


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {value, limit}}): every number at or under its
    limit and finite; a number without a limit, or a limit without a
    number, is not correct."""
    checks, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port's runs may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(c: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
            device_info: Callable[[], dict]) -> dict:
    """Run the cell and return the result line's object."""
    run = Run(name=c.workload["name"], config=c.config, mix=c.mix, seed=seed,
              seconds=seconds, trace=trace, device=device, t0=t0)
    driver = load_module(HERE / "drivers" / f"{c.mix['driver']}.py")
    outcome = driver.run(run)
    info = device_info()
    info["memory_peak_bytes"] = outcome.memory_peak_bytes
    numbers = outcome.check()
    correct, checks = verdict(numbers, c.limits)
    correct = correct and run.failed == 0
    metrics = read_metrics(run, c.per_layer if trace else c.end_to_end)
    result = {"correct": correct, "attempted": run.units, "failed": run.failed,
              "metrics": metrics, "device": info}
    if trace and run.traced is not None:
        info["busy_s"] = run.traced.busy_s
        info["window_s"] = run.traced.window_s
        result["breakdown"] = run.traced.breakdown()
    result["checks"] = checks
    return result


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of stderr."""
    for name, check in checks.items():
        print(f"check {name}: {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
