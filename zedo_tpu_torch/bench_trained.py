"""The committed trained fixture: held-out scenes and hypothesis inits.

The port's copy of the scene helpers of zedo_tpu/bench_trained.py (numpy
only), so the port can check its accuracy on tests/fixtures/trained (a
hidden-256 prior trained on a synthetic pose family, shipped in the
reference's .pth layout).
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
