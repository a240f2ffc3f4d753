"""The committed trained fixture: held-out scenes, hypothesis inits and the
trained-weight accuracy bounds.

Port of zedo_tpu/bench_trained.py, so the port can check its accuracy on
tests/fixtures/trained (a hidden-256 prior trained on a synthetic pose
family, shipped in the reference's .pth layout). `run_trained_bounds` is
what `python -m zedo_tpu_torch.bench --trained` reports.
"""
from __future__ import annotations

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                       "fixtures", "trained")
CHECKPOINT = os.path.join(FIXTURE, "checkpoint", "checkpoint_trained.pth")
CLUSTERS = os.path.join(FIXTURE, "clusters", "h36m_cluster2.npy")


def load_fixture(device="cuda"):
    """(model_cfg, fp32 params, family npz) from the committed artifact."""
    from zedo_tpu_torch.models import score_mlp
    from zedo_tpu_torch.utils.checkpoint import load_torch_checkpoint

    family = np.load(os.path.join(FIXTURE, "family.npz"))
    cfg = score_mlp.ScoreMLPConfig(
        n_joints=17, joint_dim=3, hidden_dim=int(family["hidden"]),
        embed_dim=int(family["embed"]), n_blocks=int(family["n_blocks"]),
        embedding_type="positional")
    params = load_torch_checkpoint(CHECKPOINT, cfg, device)["params"]
    return cfg, params, family


def make_scenes(family, n, seed=11):
    """Held-out family draws at any N (same camera as the fixture scenes):
    (gt [n, 17, 3] root-relative, k [n, 3, 3], px [n, 17, 2])."""
    mu, u = family["mu"], family["u"]
    fx, cx = float(family["fx"]), float(family["cx"])
    t_vec = family["t_vec"]
    rng = np.random.RandomState(seed)
    z = rng.randn(n, u.shape[0]).astype(np.float32)
    gt = mu[None] + np.einsum("nr,rjd->njd", z, u)
    gt = (gt - gt[:, 0:1]).astype(np.float32)
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = fx
    k[:, 0, 2] = k[:, 1, 2] = cx
    k[:, 2, 2] = 1.0
    cam = gt + t_vec[None, None]
    px = np.einsum("bij,bnj->bni", k, cam)
    px = (px[..., :2] / px[..., 2:]).astype(np.float32)
    return gt, k, px


def make_hypothesis_clusters(family, s, seed=5):
    """S plausible-but-wrong inits drawn from the family, root-centred."""
    mu, u = family["mu"], family["u"]
    rng = np.random.RandomState(seed)
    z = rng.randn(s, u.shape[0]).astype(np.float32)
    c = mu[None] + np.einsum("sr,rjd->sjd", z, u)
    return (c - c[:, 0:1]).astype(np.float32)


def best_mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Best-hypothesis MPJPE in mm of root-centred predictions:
    pred [N, S, j, 3], gt [N, j, 3] root-relative."""
    pred = pred - pred[:, :, 0:1]
    err = np.sqrt(((pred - gt[:, None]) ** 2).sum(-1)).mean(-1)  # [N, S]
    return float(err.min(-1).mean() * 1000)


def pose_delta(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-joint distance in mm between two pose arrays [..., 3]."""
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean() * 1000)


def run_trained_bounds(n=886, s=50, oil_iterations=1000, ipo_iterations=500, seed=11,
                       device="cuda") -> dict:
    """Solve the trained prior at [n, s] in fp32, bf16 (the fused kernel on
    the card), bf16 with score_reuse 2 and 4, and the re-discretized short
    schedule (OIL iterations // 5, reuse 2); return the accuracy ledger
    (floats, mm) under the keys of zedo_tpu/bench_trained.run_trained_bounds."""
    import torch

    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.models.nn import tree_map
    from zedo_tpu_torch.zeroshot import ipo as ipo_lib
    from zedo_tpu_torch.zeroshot import oil as oil_lib
    from zedo_tpu_torch.zeroshot import pipeline

    cfg, params, family = load_fixture(device)
    dev = params["post_dense"]["weight"].device
    gt, k, px = make_scenes(family, n, seed=seed)
    clusters = make_hypothesis_clusters(family, s)
    params_bf16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    ipo_cfg = ipo_lib.IPOConfig(iterations=ipo_iterations, keypoint_list=(0, 1, 4),
                                rot_axes="z", t_norm=3.0)

    def solve(prm, reuse, iterations=oil_iterations, sde_steps=1000):
        sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=sde_steps, t_max=0.1)
        sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                            probability_flow=True, denoise=True, eps=0.01)
        zcfg = pipeline.ZeDOConfig(ipo=ipo_cfg, oil=oil_lib.OILConfig(
            iterations=iterations, sampling_eps=0.01, score_reuse=reuse))
        with torch.no_grad():
            res = pipeline.solve(prm, cfg, sde, sampler, zcfg,
                                 torch.from_numpy(clusters).to(dev),
                                 torch.from_numpy(px).to(dev), None,
                                 torch.from_numpy(k).to(dev))
        return res.poses.float().cpu().numpy()  # [n, s, 17, 3]

    pred_fp32 = solve(params, 1)
    pred_bf16 = solve(params_bf16, 1)
    pred_r2 = solve(params_bf16, 2)
    pred_r4 = solve(params_bf16, 4)
    # the low-latency operating point: the same T->eps annealing
    # re-discretized to 1/5 the steps (sde.n := iterations) with reuse 2
    short_iters = max(2, oil_iterations // 5)
    pred_short = solve(params_bf16, 2, short_iters, sde_steps=short_iters)

    init_mm = float(np.sqrt(((clusters[None, 0] - gt) ** 2).sum(-1)).mean() * 1000)
    return {
        "n": n, "s": s,
        "fp32_mpjpe_mm": best_mpjpe(pred_fp32, gt),
        "bf16_mpjpe_mm": best_mpjpe(pred_bf16, gt),
        "bf16_delta_mm": pose_delta(pred_fp32, pred_bf16),
        "reuse2_mpjpe_mm": best_mpjpe(pred_r2, gt),
        "reuse2_delta_mm": pose_delta(pred_bf16, pred_r2),
        "reuse4_mpjpe_mm": best_mpjpe(pred_r4, gt),
        "reuse4_delta_mm": pose_delta(pred_bf16, pred_r4),
        "short_iters": short_iters,
        "short_reuse2_mpjpe_mm": best_mpjpe(pred_short, gt),
        "init_mm": init_mm,
    }
