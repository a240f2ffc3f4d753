"""Camera-frame transforms and pinhole projection (port of
zedo_tpu/ops/camera.py). Full f32: TF32 is off on the card
(utils/config.resolve_device)."""
from __future__ import annotations

import torch

from zedo_tpu_torch.ops.linalg import inv_intrinsics


def world_to_camera_frame(p: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Points [N, 3] world -> camera: R @ (P^T - T), T [3, 1]."""
    return torch.matmul(r, p.T - t).T


def camera_to_world_frame(p: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Points [N, 3] camera -> world: R^T @ P^T + T, T [3, 1]."""
    return (torch.matmul(r.T, p.T) + t).T


def image_to_camera_frame(pose3d_image_frame: torch.Tensor, box: torch.Tensor, cx, cy, fx, fy,
                          root_depth) -> torch.Tensor:
    """Image-frame pose [j, 3] (pixels and a depth relative to the root) ->
    camera frame. `box` is [4] (x1, y1, x2, y2); the depth is decoded
    against a 2000-unit canonical box."""
    rectangle_3d_size = 2000.0
    ratio = (box[2] - box[0] + 1) / rectangle_3d_size
    z = pose3d_image_frame[:, 2] / ratio + root_depth
    x = (pose3d_image_frame[:, 0] - cx) / fx * z
    y = (pose3d_image_frame[:, 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)


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
