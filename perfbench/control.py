"""The readings that the limits of `correct` are set from, on the card at a
cell's own size: for each seed, one short window of the cell, then the
numbers of `correct` for the program and for each thing put in its place
(the control, the reference in the precision below the configuration's,
and the planted faults the cell's driver offers).

    python3 -m perfbench.control --workload <name> --seeds 1,2,3 [--seconds 3]

One JSON line a seed: {"seed", "units", "program": {number: value},
<name>: {number: value}, ...}. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import harness


def readings(cell: harness.Cell, seed: int, seconds: float, device, controls: bool) -> dict:
    run = harness.Run(name=cell.workload["name"], config=cell.config, mix=cell.mix, seed=seed,
                      seconds=seconds, trace=False, device=device, t0=time.perf_counter())
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.mix['driver']}.py")
    outcome = driver.run(run)
    out = {"seed": seed, "units": run.units, "failed": run.failed,
           "program": outcome.check()}
    for name, fn in outcome.controls.items() if controls else ():
        out[name] = fn()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", type=int, default=3,
                    help="the first this many seeds read the controls too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control readings are taken on a CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    for i, seed in enumerate(map(int, args.seeds.split(","))):
        print(json.dumps(readings(cell, seed, args.seconds, torch.device("cuda", 0),
                                  i < args.controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
