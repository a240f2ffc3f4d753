"""Headline benchmark: the full H36M-scale zero-shot solve on one card.

Workload: N=886 poses x S=50 hypotheses, 500 IPO Adam steps + 1000 OIL
steps (each OIL step = translation solve + ray gradient + one score-network
forward on [N*S, 51] -> the 1024-wide residual MLP, the fused CUDA kernel
with bf16 weights). Synthetic inputs, random seeded weights: the same
compute as a trained checkpoint.

    python -m zedo_tpu_torch.bench [--n 886] [--s 50] [--fp32] [--reuse 1]
        [--oil 0] [--trained] [--device cuda]

Port of bench.py on one device. It runs the compiled solve once (first run:
kernel build, warm-up and capture of the steps' CUDA graphs) and times the
second, host clock around `pipeline.solve_jit` (JAX's bench runs the jitted
sharded solve) plus its one device-to-host copy, with an IPO/OIL split
(utils.profiling.Stopwatch, a device synchronize between the two phases)
printed on the line before the result. Prints one JSON line:
  {"metric": "h36m_s50_eval_wallclock", "value": <s>, "unit": "s",
   "extras": {...}}
The port's rates and shares of the card's peak are perfbench/'s
(BENCHMARK.json). The mesh, the compilation cache and the relay watchdog
of bench.py are TPU matters and have no counterpart here. `--trained`
reports the accuracy bounds of the committed trained fixture
(bench_trained.run_trained_bounds).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from zedo_tpu_torch import bench_trained
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.utils.profiling import Stopwatch
from zedo_tpu_torch.zeroshot import pipeline


def build_inputs(n=886, s=50, j=17, seed=0):
    """The synthetic H36M-scale request: (px [n, j, 2], conf [n, j],
    k [n, 3, 3], clusters [s, j, 3])."""
    rng = np.random.RandomState(seed)
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1145.0
    k[:, 0, 2] = k[:, 1, 2] = 512.0
    k[:, 2, 2] = 1.0
    pose = rng.randn(n, j, 3).astype(np.float32) * 0.25
    pose -= pose[:, 0:1]
    t = np.zeros((n, 1, 3), np.float32)
    t[..., 2] = 4.5
    px = np.einsum("bij,bnj->bni", k, pose + t)
    px = (px[..., :2] / px[..., 2:]).astype(np.float32)
    conf = np.clip(rng.rand(n, j).astype(np.float32) + 0.3, 0, 1)
    clusters = (rng.randn(s, j, 3) * 0.25).astype(np.float32)
    return px, conf, k, clusters


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_trained(n: int, s: int, dev: torch.device) -> dict:
    """--trained: accuracy bounds on the committed trained checkpoint."""
    t0 = time.time()
    out = bench_trained.run_trained_bounds(n=n, s=s, device=dev)
    out["wallclock_5_solves_s"] = round(time.time() - t0, 3)
    return {
        "metric": f"trained_accuracy_n{n}_s{s}",
        "value": round(out["fp32_mpjpe_mm"], 3),
        "unit": "mm",
        "extras": {k: (round(v, 4) if isinstance(v, float) else v) for k, v in out.items()}
        | {"device_kind": device_kind(dev),
           "checkpoint": "tests/fixtures/trained (hidden 256, 3000 steps)"},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=886)
    ap.add_argument("--s", type=int, default=50)
    ap.add_argument("--fp32", action="store_true", help="fp32 weights (the unfused model)")
    ap.add_argument("--reuse", type=int, default=1, help="OILConfig.score_reuse")
    ap.add_argument("--oil", type=int, default=0,
                    help="OIL iterations of a re-discretized short schedule (0 = 1000)")
    ap.add_argument("--trained", action="store_true",
                    help="accuracy bounds on the committed trained fixture")
    ap.add_argument("--tile", type=int, default=0,
                    help="no counterpart on the card: the kernel's row tile is fixed "
                         "(128 rows), so only 0 is accepted")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tile:
        ap.error("--tile has no counterpart: the CUDA kernel's row tile is fixed")
    dev = resolve_device(args.device)
    n, s = args.n, args.s
    if args.trained:
        result = run_trained(n, s, dev)
        print(json.dumps(result), flush=True)
        return result

    dtype = "fp32" if args.fp32 else "bf16"
    px, conf, k, clusters = build_inputs(n=n, s=s)
    cfg = score_mlp.ScoreMLPConfig()
    params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    if dtype == "bf16":
        params = tree_map(lambda a: a.to(torch.bfloat16), params)
    oil_iters = args.oil or 1000
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=oil_iters, t_max=0.1)
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=0.01)
    zcfg = pipeline.ZeDOConfig()
    zcfg = dataclasses.replace(zcfg, oil=dataclasses.replace(
        zcfg.oil, score_reuse=args.reuse, iterations=oil_iters))
    inputs = [torch.from_numpy(a).to(dev) for a in (clusters, px, conf, k)]

    def run(stopwatch=None):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipeline.solve_jit(params, cfg, sde, sampler, zcfg, *inputs,
                                     stopwatch=stopwatch)
            poses = out.poses.cpu()  # the one device-to-host copy
        return time.perf_counter() - t0, float(poses.sum())

    first, _ = run()
    sw = Stopwatch()
    elapsed, checksum = run(sw)
    if not np.isfinite(checksum):
        raise RuntimeError(f"non-finite poses (checksum {checksum})")
    print(f"phases: {sw.report()}", flush=True)

    n_evals = -(-oil_iters // args.reuse)
    metric = ("h36m_s50_eval_wallclock" if (n, s) == (886, 50)
              else f"eval_wallclock_n{n}_s{s}")
    if args.reuse > 1:
        metric += f"_reuse{args.reuse}"
    if oil_iters != 1000:
        metric += f"_oil{oil_iters}"
    result = {
        "metric": metric,
        "value": round(elapsed, 3),
        "unit": "s",
        "extras": {
            "poses_per_s": round(n * s / elapsed, 1),
            "compile_plus_first_run_s": round(first, 3),
            # the sum of the timed solve's poses, as the host read them
            "poses_checksum": checksum,
            "ipo_s": round(sw.totals["ipo"], 3),
            "oil_s": round(sw.totals["oil"], 3),
            "dtype": dtype,
            "devices": 1,
            "device_kind": device_kind(dev),
            "score_reuse": args.reuse,
            "nfe": n_evals,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
