"""Init Pose Optimization (IPO): fit a global rotation + translation scale so
the cluster init pose reprojects onto the observed 2D keypoints.

Port of zedo_tpu/zeroshot/ipo.py: a per-sample quaternion whose real part
starts at 1 and whose imaginary parts exist ONLY for the axes named in
`rot_axes`, plus a translation scale clamped to [min_scale_t, max_scale_t]
in the forward pass. Loss is mean L1 on the projected xy of the
`keypoint_list` joints; torch autograd gives the gradients and a written-out
Adam with optax's semantics (lr 0.1, betas (0.9, 0.999), eps 1e-8, eps
added after the bias-corrected square root) takes the steps.

Hypotheses may be folded into the batch (`n_groups`): the loss is then the
sum over groups of each group's own mean, so every hypothesis sees exactly
the gradient of its own mean loss. A plain mean over the folded batch would
shrink each gradient by 1/S, and Adam's eps term would bend the trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from zedo_tpu_torch.ops.linalg import inv_intrinsics
from zedo_tpu_torch.ops.rotations import quaternion_to_matrix


@dataclasses.dataclass(frozen=True)
class IPOConfig:
    """Mirrors the config.ZeDO IPO_* keys."""

    iterations: int = 500
    keypoint_list: tuple = (0, 1, 4)
    rot_axes: str = "z"
    t_norm: float = 3.0  # IPO_T
    min_scale_t: float = 0.5
    max_scale_t: float = 2.0
    lr: float = 0.1


class IPOResult(NamedTuple):
    rot_mat: torch.Tensor  # [B, 3, 3]
    translation: torch.Tensor  # [B, 1, 3] — T * clamp(scale)
    quaternion: torch.Tensor  # [B, 4]
    scale: torch.Tensor  # [B, 1, 1] raw (unclamped) learned scale
    loss: torch.Tensor  # final loss (diagnostic)


def init_translation(cond2d: torch.Tensor, k: torch.Tensor, t_norm: float,
                     pelvis=None) -> torch.Tensor:
    """Pelvis back-projection scaled to ||T|| = t_norm. Returns [B, 1, 3]."""
    if pelvis is None:
        pelvis = cond2d[:, 0, :2]
    hom = torch.cat([pelvis, torch.ones_like(pelvis[:, :1])], dim=-1)
    t = torch.einsum("bij,bj->bi", inv_intrinsics(k), hom)
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True) * t_norm
    return t[:, None, :]


def _quaternion(params: dict, batch: int, rot_axes: str) -> torch.Tensor:
    """[B, 4] wxyz quaternions; non-learned axes are constant zero."""
    zeros = torch.zeros_like(params["rot_vect"])
    comps = [params["rot_vect"]]
    for axe in "xyz":
        comps.append(params[f"rot_vect_{axe}"] if axe in rot_axes else zeros)
    return torch.cat(comps, dim=-1)


def _quat_rotate(quat: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Rotate [B, n, 3] points by [B, 4] (non-unit) quaternions:
    p' = p + (2/|q|^2) (w (v x p) + v x (v x p))."""
    w = quat[:, 0][:, None, None]
    v = quat[:, None, 1:].expand_as(pose)
    s = (2.0 / (quat * quat).sum(-1))[:, None, None]
    vxp = torch.linalg.cross(v, pose)
    return pose + s * (w * vxp + torch.linalg.cross(v, vxp))


def _project_pose(quat, scale, pose, t, k, cfg: IPOConfig):
    """Rotate, translate by T * clamp(scale), pinhole-project."""
    x = _quat_rotate(quat, pose)
    x = x + t * scale.clamp(cfg.min_scale_t, cfg.max_scale_t)
    px = (x * k[:, None, 0, :]).sum(-1)
    py = (x * k[:, None, 1, :]).sum(-1)
    pz = (x * k[:, None, 2, :]).sum(-1)
    return torch.stack([px / pz, py / pz], dim=-1)


def run_ipo(pose: torch.Tensor, cond2d: torch.Tensor, k: torch.Tensor,
            cfg: IPOConfig, t=None, n_groups: int = 1) -> IPOResult:
    """Fit rotation + translation scale.

    pose: [B, j, 3] root-relative init pose; cond2d: [B, j, >=2] observed 2D
    keypoints; k: [B, 3, 3]; t: optional [B, 1, 3] initial translation
    (defaults to the pelvis ray). n_groups: hypotheses folded into B, each
    of B / n_groups contiguous rows, each normalized as its own mean.
    """
    batch = pose.shape[0]
    if batch % n_groups:
        raise ValueError(f"batch {batch} does not split into {n_groups} groups")
    keylist = torch.as_tensor(cfg.keypoint_list, device=pose.device)
    pose_sel = pose[:, keylist, :].detach()
    target = cond2d[:, keylist, :2].detach()
    if t is None:
        t = init_translation(cond2d, k, cfg.t_norm)
    t = t.detach()
    k = k.detach()

    def zeros(*shape):
        return torch.zeros(shape, dtype=pose.dtype, device=pose.device)

    params = {"rot_vect": zeros(batch, 1) + 1, "scale": zeros(batch, 1, 1) + 1}
    for axe in cfg.rot_axes:
        params[f"rot_vect_{axe}"] = zeros(batch, 1)
    names = list(params)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8

    loss = zeros()
    for step in range(1, cfg.iterations + 1):
        with torch.enable_grad():
            leaves = {n: params[n].requires_grad_(True) for n in names}
            quat = _quaternion(leaves, batch, cfg.rot_axes)
            px = _project_pose(quat, leaves["scale"], pose_sel, t, k, cfg)
            loss = (px - target).abs().reshape(n_groups, -1).mean(1).sum()
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        with torch.no_grad():
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for n, g in zip(names, grads):
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
                params[n] = params[n].detach() - cfg.lr * upd
        loss = loss.detach()

    quat = _quaternion(params, batch, cfg.rot_axes)
    scale = params["scale"]
    return IPOResult(
        rot_mat=quaternion_to_matrix(quat),
        translation=t * scale.clamp(cfg.min_scale_t, cfg.max_scale_t),
        quaternion=quat, scale=scale, loss=loss,
    )
