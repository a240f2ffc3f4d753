"""Ray-projection gradient field: the geometric half of the OIL loop.

Port of the pieces of zedo_tpu/ops/gradient_field.py that the OIL fast path
runs. The 3x3 normal equations of the translation solve are assembled in
closed form with weighted reductions over the joint axis.

Weighting: the reference scales BOTH the rows of A and of b by conf^2, so
the normal equations carry conf^4 on each side. That double weighting is
kept verbatim, since published metrics depend on it.
"""
from __future__ import annotations

from typing import Optional

import torch


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
