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

The loop is a scan (utils/compiled.py), JAX's one `lax.scan` of Adam steps:
the carry is the parameters, Adam's moments and the loss; the per-step input
is Adam's two bias corrections, read from a [iterations, 2] table at the
device step counter. `run_ipo(compiled=True)` replays the step as a CUDA
graph; the eager loop runs the same body.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from zedo_tpu_torch.ops.linalg import inv_intrinsics
from zedo_tpu_torch.ops.rotations import quaternion_to_matrix
from zedo_tpu_torch.utils.compiled import scan

B1, B2, EPS = 0.9, 0.999, 1e-8


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


def adam_corrections(iterations: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[iterations, 2] Adam's bias corrections (1 - b1^step, 1 - b2^step) of
    steps 1..iterations, the IPO scan's per-step input, as the step applies
    them: Python's double power rounded once to the pose dtype, which the CPU
    divides by; on CUDA its reciprocal taken in double and rounded to the
    pose dtype, which the step multiplies by, as PyTorch's CUDA division by
    a Python float does."""
    table = [(1.0 - B1 ** s, 1.0 - B2 ** s) for s in range(1, iterations + 1)]
    if torch.device(device).type == "cuda":
        table = [(1.0 / c1, 1.0 / c2) for c1, c2 in table]
    return torch.tensor(table, dtype=dtype).reshape(-1, 2).to(device)


def _ipo_body(carry, consts, ys, counter, generator, variant, *, cfg: IPOConfig, n_groups: int,
              reciprocal: bool):
    """One Adam step: the loss's gradient by autograd, then optax's update
    with the step's bias corrections from the table (their reciprocals on
    CUDA: `adam_corrections`)."""
    params, mu, nu = carry["params"], carry["mu"], carry["nu"]
    with torch.enable_grad():
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        quat = _quaternion(leaves, consts["pose"].shape[0], cfg.rot_axes)
        px = _project_pose(quat, leaves["scale"], consts["pose"], consts["t"], consts["k"], cfg)
        loss = (px - consts["target"]).abs().reshape(n_groups, -1).mean(1).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        c1, c2 = consts["corrections"].index_select(0, counter).reshape(2).unbind(0)
        new = {}
        for (n, p), g in zip(params.items(), grads):
            mu[n].mul_(B1).add_(g, alpha=1 - B1)
            nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
            if reciprocal:
                upd = (mu[n] * c1) / (torch.sqrt(nu[n] * c2) + EPS)
            else:
                upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + EPS)
            new[n] = p - cfg.lr * upd
    return {"params": new, "mu": mu, "nu": nu, "loss": loss.detach()}


def run_ipo(pose: torch.Tensor, cond2d: torch.Tensor, k: torch.Tensor,
            cfg: IPOConfig, t=None, n_groups: int = 1, compiled: bool = False) -> IPOResult:
    """Fit rotation + translation scale.

    pose: [B, j, 3] root-relative init pose; cond2d: [B, j, >=2] observed 2D
    keypoints; k: [B, 3, 3]; t: optional [B, 1, 3] initial translation
    (defaults to the pelvis ray). n_groups: hypotheses folded into B, each
    of B / n_groups contiguous rows, each normalized as its own mean.
    compiled: the step as a compiled scan (a CUDA graph on the card).
    """
    batch = pose.shape[0]
    if batch % n_groups:
        raise ValueError(f"batch {batch} does not split into {n_groups} groups")
    keylist = torch.as_tensor(cfg.keypoint_list, device=pose.device)
    if t is None:
        t = init_translation(cond2d, k, cfg.t_norm)
    consts = {"pose": pose[:, keylist, :].detach(), "target": cond2d[:, keylist, :2].detach(),
              "t": t.detach(), "k": k.detach(),
              "corrections": adam_corrections(cfg.iterations, pose.dtype, pose.device)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=pose.dtype, device=pose.device)

    params = {"rot_vect": zeros(batch, 1) + 1, "scale": zeros(batch, 1, 1) + 1}
    for axe in cfg.rot_axes:
        params[f"rot_vect_{axe}"] = zeros(batch, 1)
    carry = {"params": params,
             "mu": {n: torch.zeros_like(p) for n, p in params.items()},
             "nu": {n: torch.zeros_like(p) for n, p in params.items()},
             "loss": zeros()}
    body = functools.partial(_ipo_body, cfg=cfg, n_groups=n_groups,
                             reciprocal=pose.device.type == "cuda")
    carry, _ = scan(body, (None,) * cfg.iterations, carry, consts, {}, compiled=compiled)

    params = carry["params"]
    quat = _quaternion(params, batch, cfg.rot_axes)
    scale = params["scale"]
    return IPOResult(
        rot_mat=quaternion_to_matrix(quat),
        translation=consts["t"] * scale.clamp(cfg.min_scale_t, cfg.max_scale_t),
        quaternion=quat, scale=scale, loss=carry["loss"],
    )
