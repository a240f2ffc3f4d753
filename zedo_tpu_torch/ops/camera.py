"""Pinhole projection and back-projection (port of the part of
zedo_tpu/ops/camera.py that the zero-shot solve runs). Full f32: TF32 is off
on the card (utils/config.resolve_device)."""
from __future__ import annotations

import torch

from zedo_tpu_torch.ops.linalg import inv_intrinsics


def project(points3d: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., j, 3] points, [..., 3, 3] K -> [..., j, 2] pixels."""
    proj = torch.einsum("...ij,...nj->...ni", k, points3d)
    return proj[..., :2] / proj[..., 2:]


def backproject_rays(points2d: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., j, 2] pixels, [..., 3, 3] K -> [..., j, 3] rays with z == 1."""
    kinv = inv_intrinsics(k)
    ones = torch.ones(points2d.shape[:-1] + (1,), dtype=points2d.dtype,
                      device=points2d.device)
    hom = torch.cat([points2d, ones], dim=-1)
    rays = torch.einsum("...ij,...nj->...ni", kinv, hom)
    return rays / rays[..., 2:]
