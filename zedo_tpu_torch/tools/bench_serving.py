"""Serving latency: ZeDOEstimator.predict p50/p95 across request sizes (one
pose, a small batch, the bucket), at score_reuse 1 and 2.

    python -m zedo_tpu_torch.tools.bench_serving [--hypo 5] [--reps 9] [--device cuda]
    python -m zedo_tpu_torch.tools.bench_serving --oil 200 --ipo 100 --bucket 32
        # the low-latency preset (ZeDOEstimator.low_latency): the schedule
        # re-discretized, a small bucket for requests of up to 32 poses

Port of tools/bench_serving.py. The prior is the published width (hidden
1024, embed 512, 2 blocks) with random seeded bf16 weights, so on the card
every OIL forward is the fused CUDA kernel (kernel #1) on bucket x hypo rows;
the clusters are seeded randn * 0.25 and the scenes bench.build_inputs(n,
s=1, seed=n). Each request size is served once untimed (the first use of
its shapes), then `--reps` times, each timed on the host clock to the end of
predict's one device-to-host copy. Prints one line per (reuse, N):
  reuse=R N=n S=s: p50 ... ms  p95 ... ms  (... poses/s)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from zedo_tpu_torch import presets
from zedo_tpu_torch.bench import build_inputs
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.utils.config import resolve_device

REQUEST_SIZES = (1, 16, 32, 256)
REUSES = (1, 2)


def request_sizes(bucket: int) -> list[int]:
    """The request sizes served at `bucket`, by the JAX tool's rule: none
    above the bucket, and 32 only when the bucket is 32."""
    return [n for n in REQUEST_SIZES if n <= bucket and (n != 32 or bucket == 32)]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hypo", type=int, default=5)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--oil", type=int, default=0,
                    help="OIL iterations of a re-discretized schedule (0 = 1000)")
    ap.add_argument("--ipo", type=int, default=0, help="IPO iterations (0 = 500)")
    ap.add_argument("--bucket", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = score_mlp.ScoreMLPConfig()
    params = tree_map(lambda a: a.to(torch.bfloat16),
                      score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
    preset = presets.h36m()
    clusters = (np.random.RandomState(0).randn(args.hypo, 17, 3) * 0.25).astype(np.float32)
    results = []
    for reuse in REUSES:
        zcfg = dataclasses.replace(
            preset.zcfg, oil=dataclasses.replace(preset.zcfg.oil, score_reuse=reuse))
        est = ZeDOEstimator(params=params, model_cfg=cfg, sde=preset.sde,
                            sampler=preset.sampler, zcfg=zcfg, clusters=clusters, device=dev,
                            batch_bucket=args.bucket)
        if args.oil or args.ipo:
            # --ipo alone keeps the full 1000-step OIL schedule
            est = est.with_schedule(args.oil or None, ipo_iterations=args.ipo or None)
        for n in request_sizes(args.bucket):
            kp, _conf, k, _clusters = build_inputs(n=n, s=1, seed=n)
            est.predict(kp, k)  # untimed: the first use of the bucket's shapes
            lat = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = est.predict(kp, k)
                lat.append(time.perf_counter() - t0)
            if not np.isfinite(out["poses"]).all():
                raise RuntimeError(f"non-finite poses at reuse={reuse} N={n}")
            lat_ms = np.array(sorted(lat)) * 1000.0
            p50, p95 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 95)
            print(f"reuse={reuse} N={n:>4} S={args.hypo}: p50 {p50:8.1f} ms"
                  f"  p95 {p95:8.1f} ms  ({n / p50 * 1000:.1f} poses/s)", flush=True)
            results.append({"reuse": reuse, "n": n, "s": args.hypo, "p50_ms": float(p50),
                            "p95_ms": float(p95), "poses_per_s": float(n / p50 * 1000),
                            "requests": args.reps + 1, "oil_iterations": est.zcfg.oil.iterations,
                            "ipo_iterations": est.zcfg.ipo.iterations,
                            "rows": -(-n // args.bucket) * args.bucket * args.hypo})
    return results


if __name__ == "__main__":
    main()
