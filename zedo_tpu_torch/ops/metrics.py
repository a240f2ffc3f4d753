"""Pose-estimation metrics: MPJPE, PA-MPJPE, PCK, AUC.

Port of zedo_tpu/ops/metrics.py. The tensor functions run on the device of
their inputs; only scalars come back to the host. `mean_cov` and
`mahalanobis` are numpy, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from zedo_tpu_torch.ops.procrustes import align_to_gt_batched


def per_joint_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Euclidean error per joint: [..., j, 3] -> [..., j]."""
    return torch.sqrt(((pred - gt) ** 2).sum(-1))


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error: [..., j, 3] -> [...]."""
    return per_joint_error(pred, gt).mean(-1)


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE (protocol 2): [..., j, 3] -> [...]."""
    return mpjpe(align_to_gt_batched(pred, gt), gt)


def min_over_hypotheses(errors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (min error, argmin hypothesis) over axis 1 of [N, S] errors.
    The argmin is the first index of the minimum, as `jnp.argmin`'s."""
    arg = torch.argmin(errors, dim=1)
    return errors.gather(1, arg[:, None])[:, 0], arg


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def joint_errors_mm(gts, preds, scale: float = 1000.0, eval_joints=None) -> torch.Tensor:
    """[N, j] per-joint errors in mm, the shared input of PCK and AUC. On the
    device of `preds` when it is a tensor."""
    preds = _as_f32(preds)
    err_mm = per_joint_error(preds, _as_f32(gts, preds.device)) * scale
    if eval_joints is not None:
        err_mm = err_mm[:, torch.as_tensor(eval_joints, device=err_mm.device)]
    return err_mm


def pck_from_errors(err_mm: torch.Tensor, threshold: float = 150.0) -> float:
    """PCK at `threshold` mm from a precomputed [N, j] error matrix."""
    true_positive = int((err_mm < threshold).sum())
    return float(true_positive / err_mm.numel()) * 100.0


def auc_from_errors(err_mm: torch.Tensor) -> float:
    """PCK-curve area (thresholds 0..150 mm, 31 steps) from [N, j] errors."""
    thresholds = torch.linspace(0.0, 150.0, 31, device=err_mm.device)
    hits = (err_mm[None] < thresholds[:, None, None]).sum((1, 2))
    pcks = hits.cpu().numpy().astype(np.float64) / err_mm.numel() * 100.0
    return float(np.mean(pcks))


def compute_pck(gts, preds, scale: float = 1000.0, eval_joints=None,
                threshold: float = 150.0) -> float:
    """Percentage of Correct Keypoints at `threshold` mm.
    gts/preds: [N, j, 3] in meters; `scale` converts to mm."""
    return pck_from_errors(joint_errors_mm(gts, preds, scale, eval_joints), threshold)


def compute_auc(gts, preds, scale: float = 1000.0, eval_joints=None) -> float:
    """Area under the PCK curve for thresholds 0..150 mm in 31 steps."""
    return auc_from_errors(joint_errors_mm(gts, preds, scale, eval_joints))


def mean_cov(x: np.ndarray):
    """Mean and the reference's (degenerate, identity) covariance."""
    x = np.asarray(x).reshape((x.shape[0], -1))
    m = np.mean(x, axis=0)
    return m, np.identity(m.shape[0])


def mahalanobis(m=None, cov=None, x=None):
    """Identity-covariance Mahalanobis distances: with cov forced to the
    identity, as the reference does, squared distance to the mean."""
    x = np.asarray(x)
    res = []
    for i in range(x.shape[0]):
        x_mu = x[i].reshape(x[i].shape[0], -1) - m
        res.append((x_mu @ x_mu.T).diagonal())
    return np.array(res)
