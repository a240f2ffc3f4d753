"""bf16 (the fused CUDA kernel) against fp32 end to end.

Runs the full pipeline (500 IPO + 1000 OIL steps) twice on a synthetic
camera scene, once with fp32 weights (the unfused model in full f32) and
once with bf16 weights (the fused kernel on the card, GroupNorm statistics
in the default bf16 mode), and reports how far the two final poses and
MPJPEs diverge. Synthetic ground truth gives an absolute yardstick in mm.

    python -m zedo_tpu_torch.tools.validate_dtype [--hypo 4] [--n 886] [--device cuda]

Port of tools/validate_dtype.py, with its scene: clusters seeded near the
ground-truth poses and a damped output head, so the loop converges and the
difference is measured in the operating regime rather than on a diverging
solve. The random prior is the port's own (torch generator, seed 0).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from zedo_tpu_torch import presets
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops import camera
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.zeroshot import pipeline


def make_scene(n: int, s: int):
    """(gt [n, 17, 3], px [n, 17, 2], k [n, 3, 3], clusters [s, 17, 3]) of
    the tool's fixture: poses 4.5 m in front of a 1145 px camera, clusters
    the first s poses plus 0.1 m noise."""
    rng = np.random.RandomState(0)
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1145.0
    k[:, 0, 2] = k[:, 1, 2] = 512.0
    k[:, 2, 2] = 1.0
    gt = rng.randn(n, 17, 3).astype(np.float32) * 0.25
    gt -= gt[:, 0:1]
    t = np.zeros((n, 1, 3), np.float32)
    t[..., 2] = 4.5
    px = camera.project(torch.from_numpy(gt + t), torch.from_numpy(k)).numpy()
    clusters = gt[:s] + rng.randn(s, 17, 3).astype(np.float32) * 0.1
    return gt, px, k, clusters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=886)
    ap.add_argument("--hypo", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gt, px, k, clusters = make_scene(args.n, args.hypo)

    preset = presets.h36m()
    cfg = score_mlp.ScoreMLPConfig()
    params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    # damp the output head: an undamped random prior makes the optimization
    # diverge; a small head mimics a trained score near t -> 0 and keeps the
    # loop in its operating regime, which is what is compared across dtypes
    for name in ("weight", "bias"):
        params["post_dense"][name] = params["post_dense"][name] * 0.05
    zcfg = pipeline.ZeDOConfig()

    def solve(p):
        with torch.no_grad():
            out = pipeline.solve_jit(p, cfg, preset.sde, preset.sampler, zcfg,
                                     torch.from_numpy(clusters).to(dev),
                                     torch.from_numpy(px).to(dev), None,
                                     torch.from_numpy(k).to(dev))
        return out.poses.double().cpu().numpy()

    poses32 = solve(params)
    poses16 = solve(tree_map(lambda a: a.to(torch.bfloat16), params))

    bounded = np.abs(poses32).max(axis=(1, 2, 3)) < 10.0  # sane-scale samples
    gt_b = gt[bounded]

    def mpjpe(p):
        per = np.sqrt(((p - gt_b[:, None]) ** 2).sum(-1)).mean(-1)  # [nb, s]
        return per.min(axis=1).mean() * 1000  # mm, min over hypotheses

    delta = np.abs(poses32[bounded] - poses16[bounded])
    m32, m16 = mpjpe(poses32[bounded]), mpjpe(poses16[bounded])
    print(f"bounded samples: {bounded.sum()}/{args.n}")
    print(f"pose |delta| mean: {delta.mean() * 1000:.3f} mm, "
          f"p99: {np.percentile(delta, 99) * 1000:.3f} mm, "
          f"max: {delta.max() * 1000:.3f} mm")
    print(f"MPJPE fp32: {m32:.3f} mm | bf16: {m16:.3f} mm | diff: {abs(m32 - m16):.4f} mm")
    return {"bounded": int(bounded.sum()), "n": args.n,
            "delta_mean_mm": float(delta.mean() * 1000),
            "delta_p99_mm": float(np.percentile(delta, 99) * 1000),
            "delta_max_mm": float(delta.max() * 1000),
            "mpjpe_fp32_mm": float(m32), "mpjpe_bf16_mm": float(m16),
            "mpjpe_diff_mm": float(abs(m32 - m16))}


if __name__ == "__main__":
    main()
