"""Repeated runs on one input each: kernel #1 at the main path's shapes, the
compiled and the eager solve, and `predict` at the two serving buckets, each
run held bit for bit to the first; then one request profiled several times,
the first capturing its graphs inside its trace, with kernel #1's CUDA
launches and all device events of each trace. A race in a kernel, or a
graph replayed over stale buffers, shows as a run that differs; a trace
whose counts change from one identical request to the next shows what a
check on a profiled count can rely on.

    python -m zedo_tpu_torch.tools.repeat_check [--scale 1] [--device cuda]

Seeded weights at the published width. --scale multiplies every repeat
count; --kernel-rows, --rows, --hypo, --hidden, --oil and --ipo shrink the
work (a run on the CPU, where kernel #1 is its plain version). Prints a line
a case and a last JSON line; exits 1 if a run differed from its first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from zedo_tpu_torch import bench, presets
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.ops.kernels import score_kernel as sk
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.utils import compiled
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.zeroshot import pipeline

# (hidden, joints, rows, launches): the main path's 886 x 50 request, a
# ragged batch, the serving buckets' 256 and 32 x 5, SyRIP's 36 columns at
# 500 x 20 and the trained fixture's hidden 256 at 16 x 50
KERNEL_CASES = ((1024, 17, 44300, 3000), (1024, 17, 1001, 10000), (1024, 17, 1280, 20000),
                (1024, 17, 160, 20000), (1024, 12, 10000, 5000), (256, 17, 800, 20000))
SOLVES = {"solve_jit": 30, "solve": 6}
PREDICTS = 20
PROFILES = 5
# CUDA kernels of kernel #1's library (chip_smoke.py counts the same names)
KERNEL_NAMES = ("wgmma_layer", "pad_input", "dense_layer")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=1.0, help="times every repeat count")
    p.add_argument("--kernel-rows", type=int, default=None,
                   help="rows of every kernel case (default: each case's own)")
    p.add_argument("--rows", type=int, default=886, help="poses of a solve")
    p.add_argument("--hypo", type=int, default=50, help="hypotheses of a solve")
    p.add_argument("--hidden", type=int, default=1024, help="the solves' model width")
    p.add_argument("--oil", type=int, default=None, help="OIL steps (default: the preset's)")
    p.add_argument("--ipo", type=int, default=None, help="IPO steps (default: the preset's)")
    return p.parse_args(argv)


def _bf16(params: dict) -> dict:
    return tree_map(lambda a: a.to(torch.bfloat16), params)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _repeat(name, fn, same, n, dev, out: dict) -> None:
    """fn() n times after a first run; the runs `same` does not hold equal
    to the first."""
    first = fn()
    _sync(dev)
    t0 = time.perf_counter()
    differed = sum(not same(fn(), first) for _ in range(n))
    _sync(dev)
    out[name] = {"runs": n, "differed": differed, "s": time.perf_counter() - t0}
    print(name, out[name], flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    times = lambda n: max(1, int(n * args.scale))  # noqa: E731
    gen = torch.Generator().manual_seed(5)
    out = {}

    for hidden, joints, case_rows, n in KERNEL_CASES:
        rows = args.kernel_rows or case_rows
        cfg = score_mlp.ScoreMLPConfig(n_joints=joints, hidden_dim=hidden,
                                       embed_dim=hidden // 2, group_norm_groups=hidden // 32)
        params = _bf16(score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
        temb = score_mlp.time_embedding(params, cfg, torch.full((1,), 47.3, device=dev))[0]
        x = torch.randn(rows, joints * 3, generator=gen).to(dev)
        for gn, gn_dtype in (("bf16", None), ("f32", torch.float32)):
            packed = sk.pack_weights(params, cfg, dtype=torch.bfloat16, gn_dtype=gn_dtype)
            vecs = sk.step_vectors(packed, temb).contiguous()
            # named by the case's rows, whatever --kernel-rows gave it
            _repeat(f"kernel_h{hidden}_{joints * 3}x{case_rows}_gn_{gn}",
                    lambda: sk.fused_score_forward(x, packed, vecs), torch.equal, times(n), dev,
                    out)

    preset = presets.h36m(hidden_dim=args.hidden, embed_dim=args.hidden // 2)
    cfg = preset.model_cfg
    params = _bf16(score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
    px, conf, k, clusters = bench.build_inputs(args.rows, args.hypo)

    def estimator(clusters, bucket=256):
        est = ZeDOEstimator(params=params, model_cfg=cfg, sde=preset.sde,
                            sampler=preset.sampler, zcfg=preset.zcfg, clusters=clusters,
                            device=dev, batch_bucket=bucket)
        return est.with_schedule(args.oil, ipo_iterations=args.ipo)

    est = estimator(clusters)
    inputs = [torch.from_numpy(a).to(dev) for a in (clusters, px, conf, k)]

    def same_solve(a, b):
        return torch.equal(a.poses, b.poses) and torch.equal(a.translations, b.translations)

    for name, n in SOLVES.items():
        fn = getattr(pipeline, name)

        def solve(fn=fn):
            with torch.no_grad():
                return fn(params, cfg, est.sde, est.sampler, est.zcfg, *inputs)

        _repeat(name, solve, same_solve, times(n), dev, out)

    def same_packed(a, b):
        return all(np.array_equal(a[key], value) for key, value in b.items())

    # the serving buckets as chip_smoke.py's phase 5b serves them: 5
    # hypotheses, the full schedule at 256 and the low-latency one at 32
    for bucket in (256, 32):
        served = estimator(clusters[:5], bucket)
        served = served if bucket == 256 else served.low_latency()
        b = min(bucket, args.rows)
        _repeat(f"predict_bucket_{bucket}",
                lambda s=served, b=b: s.predict(px[:b], k[:b], confidence=conf[:b]),
                same_packed, times(PREDICTS), dev, out)

    from torch.profiler import ProfilerActivity, profile

    # the first request captures its graphs inside its trace (the cache
    # emptied first); the later ones replay them
    compiled.clear_cache()
    counts = []
    for i in range(times(PROFILES) + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            est.predict(px, k, confidence=conf)
            _sync(dev)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        counts.append({"request": "first" if i == 0 else "replay",
                       "kernel_1_launches": sum(e.count for e in events
                                                if any(s in e.key for s in KERNEL_NAMES)),
                       "device_events": sum(e.count for e in events)})
        print("profiled request", counts[-1], flush=True)
    out["profiled_request"] = counts
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    result = main()
    sys.exit(1 if any(isinstance(r, dict) and r.get("differed") for r in result.values()) else 0)
