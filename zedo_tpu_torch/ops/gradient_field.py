"""Ray-projection gradient field: the geometric half of the OIL loop.

Port of zedo_tpu/ops/gradient_field.py. Per OIL step, for every pose: the
2D keypoints are back-projected through K^-1 to z=1 camera rays; the
confidence-weighted least-squares translation T is solved (optionally);
each 3D joint moves toward the foot of its perpendicular onto its ray. The
3x3 normal equations of the translation solve are assembled in closed form
with weighted reductions over the joint axis. Noise takes an explicit
torch.Generator where JAX takes a key.

Weighting: the reference scales BOTH the rows of A and of b by conf^2, so
the normal equations carry conf^4 on each side. That double weighting is
kept verbatim, since published metrics depend on it.
"""
from __future__ import annotations

from typing import Optional

import torch

from zedo_tpu_torch.ops.camera import backproject_rays
from zedo_tpu_torch.ops.linalg import solve3x3
from zedo_tpu_torch.utils import rng

NOISE_STD = 0.0001  # the reference's `std` of the gradient noise


def perpendicular_distance(point: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """Vector from `point` to its projection onto unit `vector` [..., 3]."""
    projection = (point * vector).sum(-1, keepdim=True) * vector
    return projection - point


def clamp_confidence(conf: torch.Tensor) -> torch.Tensor:
    """Clamp 2D-keypoint confidences to [1e-4, 1]."""
    return conf.clamp(1e-4, 1.0)


def normal_matrix(rx: torch.Tensor, ry: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A^T A of the stacked translation system; per joint the rows
    (-1, 0, rx) and (0, -1, ry), weighted by w = conf^4.
    rx, ry, w: [..., j]. Returns [..., 3, 3]."""
    sw = w.sum(-1)
    swrx = (w * rx).sum(-1)
    swry = (w * ry).sum(-1)
    swr2 = (w * (rx * rx + ry * ry)).sum(-1)
    zeros = torch.zeros_like(sw)
    return torch.stack([
        torch.stack([sw, zeros, -swrx], -1),
        torch.stack([zeros, sw, -swry], -1),
        torch.stack([-swrx, -swry, swr2], -1),
    ], dim=-2)


def normal_rhs(rx: torch.Tensor, ry: torch.Tensor, w: torch.Tensor,
               key3d: torch.Tensor) -> torch.Tensor:
    """A^T b of the same system for the current pose. Returns [..., 3]."""
    x, y, z = key3d[..., 0], key3d[..., 1], key3d[..., 2]
    bx = x - z * rx
    by = y - z * ry
    return torch.stack([-(w * bx).sum(-1), -(w * by).sum(-1),
                        (w * (rx * bx + ry * by)).sum(-1)], dim=-1)


def flip_negative_z(t: torch.Tensor) -> torch.Tensor:
    """Flip T where its z is negative: the camera must look at the person."""
    return torch.where(t[..., 2:] < 0, -t, t)


def confidence_weights(conf: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """conf^4 weights after clamping, or ones."""
    if conf is None:
        return torch.ones_like(like)
    c = clamp_confidence(conf)
    return (c * c) ** 2


def solve_translation(rays: torch.Tensor, key3d: torch.Tensor,
                      conf: Optional[torch.Tensor]) -> torch.Tensor:
    """Closed-form global translation from a root-relative 3D pose and its
    camera rays. rays: [..., j, 3] with z == 1; key3d: [..., j, 3]; conf:
    [..., j] raw confidences (clamped here) or None. Returns T [..., 1, 3],
    flipped where its z is negative."""
    rx, ry = rays[..., 0], rays[..., 1]
    w = confidence_weights(conf, rx)
    t = flip_negative_z(solve3x3(normal_matrix(rx, ry, w), normal_rhs(rx, ry, w, key3d)))
    return t[..., None, :]


def _noise(generator, like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) of like's shape from `generator`."""
    return rng.randn(generator, like.shape, dtype=like.dtype, device=like.device)


def gradient_field(key2d: torch.Tensor, key3d: torch.Tensor, k: torch.Tensor,
                   t: Optional[torch.Tensor] = None, conf: Optional[torch.Tensor] = None,
                   noise_type: Optional[str] = None, generator=None):
    """One OIL geometric update: per-joint gradient toward the camera rays.

    key2d: [..., j, 2] pixels; key3d: [..., j, 3] current root-relative
    pose; k: [..., 3, 3]; t: a fixed translation [..., 1, 3], or None to
    solve it; conf: [..., j] or None. noise_type: None, "gaussian" (noise
    scaled by T, as the reference adds std * randn * t) or "uniform" (the
    reference's name for randn - 0.5), drawn from `generator`, a
    torch.Generator, which a noise type requires.
    Returns (gradient [..., j, 3], T [..., 1, 3])."""
    if noise_type not in (None, "gaussian", "uniform"):
        raise ValueError(f"unknown noise_type {noise_type!r}")
    if noise_type is not None and generator is None:
        raise ValueError(f"noise_type {noise_type!r} draws its noise from `generator`; give one")
    rays = backproject_rays(key2d, k)
    conf_c = clamp_confidence(conf) if conf is not None else None
    if t is None:
        t = solve_translation(rays, key3d, conf_c)
    rays_unit = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    gradient = perpendicular_distance(key3d + t, rays_unit)
    if noise_type == "gaussian":
        gradient = gradient + NOISE_STD * _noise(generator, gradient) * t
    elif noise_type == "uniform":
        gradient = gradient + NOISE_STD * (_noise(generator, gradient) - 0.5)
    return gradient, t


def reprojection_residual(key2d: torch.Tensor, key3d: torch.Tensor,
                          k: torch.Tensor) -> torch.Tensor:
    """Largest distance between a joint and its z=1 ray point, the
    reference's `error_compute` (it compares the K^-1 rays with the joints
    directly; kept verbatim)."""
    return torch.linalg.vector_norm(backproject_rays(key2d, k) - key3d, dim=-1).max()
