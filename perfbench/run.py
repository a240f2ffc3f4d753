"""One measured run of one benchmark cell of zedo_tpu_torch on NVIDIA cards.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells are BENCHMARK.json's `workloads`.
The run makes its weights and inputs from --seed, warms up its cell's shapes
(set-up: from process start to the first timed unit), measures for --seconds
and, with --trace 1, profiles part of that window for the per-layer
metrics. Then it checks what the window produced against the plain
reference (perfbench/reference/) and prints one JSON object as the last
line of standard output, each number compared beside its limit as the last
lines of standard error. Without enough CUDA devices, or with JAX or the
JAX package loaded, it prints no result and exits with 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from perfbench import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def device_info() -> dict:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}

    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device, T0,
                             device_info)
    found = harness.loaded_forbidden()
    if found:
        print(f"modules loaded that a run of the port may not load: {found}", file=sys.stderr)
        return 2
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
