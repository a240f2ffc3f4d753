"""Procrustes alignment (protocol 2, PA-MPJPE), batched.

Port of zedo_tpu/ops/procrustes.py. The [..., j, 3] batch is folded into
one batch of 3x3 cross-covariances whose SVDs are one `torch.linalg.svd`
call, as `jnp.linalg.svd` is one XLA op there.

The JAX products run at `Precision.HIGHEST`. Here every product of the
alignment is a broadcast multiply and a sum over a 3- or j-long axis, never
a matmul, so no TF32 setting of the process can round its operands.

`R = V U^T` and `trace(s)` do not depend on the signs that an SVD picks for
its singular vectors while the singular values are distinct, so LAPACK and
cuSOLVER give the same alignment. `reflection="best"` applies no
determinant fix, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ProcrustesResult(NamedTuple):
    d: torch.Tensor  # normalized residual [...]
    z: torch.Tensor  # transformed B [..., n, dim]
    rotation: torch.Tensor  # [..., dim, dim]; Z = scale * B @ rotation + translation
    scale: torch.Tensor  # [...]
    translation: torch.Tensor  # [..., dim]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., m, k] @ [..., k, n] in full f32, as a broadcast multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def procrustes(a: torch.Tensor, b: torch.Tensor, scaling: bool = True,
               reflection="best") -> ProcrustesResult:
    """Least-squares similarity transform of `b` onto `a`.

    a, b: [..., n, dim] point sets of equal dim (the reference's dim_y <
    dim_x zero-padding branch is unreachable from every caller and not
    supported). Leading axes are a batch. `scaling` and `reflection` are
    Python values: "best" takes the SVD's rotation as it is, True or False
    forces a reflection or a proper rotation per sample."""
    if a.shape[-1] != b.shape[-1]:
        raise ValueError("dim_y < dim_x is not supported")
    a_bar = a.mean(dim=-2, keepdim=True)
    b_bar = b.mean(dim=-2, keepdim=True)
    a0 = a - a_bar
    b0 = b - b_bar

    ss_x = (a0 ** 2).sum((-2, -1))
    ss_y = (b0 ** 2).sum((-2, -1))
    a_norm = torch.sqrt(ss_x)
    b_norm = torch.sqrt(ss_y)
    a0 = a0 / a_norm[..., None, None]
    b0 = b0 / b_norm[..., None, None]

    m = _mm(a0.transpose(-1, -2), b0)  # [..., dim, dim] cross-covariance
    u, s, vt = torch.linalg.svd(m)
    v = vt.transpose(-1, -2)
    r = _mm(v, u.transpose(-1, -2))

    if reflection != "best":
        flip = (torch.linalg.det(r) < 0) != bool(reflection)
        signs = torch.ones(s.shape, dtype=s.dtype, device=s.device)
        signs[..., -1] = torch.where(flip, -1.0, 1.0).to(s.dtype)
        v = v * signs[..., None, :]
        s = s * signs
        r = _mm(v, u.transpose(-1, -2))

    s_trace = s.sum(-1)
    if scaling:
        scale = s_trace * a_norm / b_norm
        d = 1 - s_trace ** 2
        z = (a_norm * s_trace)[..., None, None] * _mm(b0, r) + a_bar
    else:
        scale = torch.ones_like(s_trace)
        d = 1 + ss_y / ss_x - 2 * s_trace * b_norm / a_norm
        z = b_norm[..., None, None] * _mm(b0, r) + a_bar

    translation = (a_bar - scale[..., None, None] * _mm(b_bar, r))[..., 0, :]
    return ProcrustesResult(d=d, z=z, rotation=r, scale=scale, translation=translation)


def align_to_gt(pose: torch.Tensor, pose_gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-align `pose` [j, 3] to `pose_gt` [j, 3]."""
    return procrustes(pose_gt, pose).z


def align_to_gt_batched(poses: torch.Tensor, poses_gt: torch.Tensor) -> torch.Tensor:
    """Alignment over any leading batch axes: poses, poses_gt [..., j, 3] ->
    aligned poses [..., j, 3], one batch of 3x3 SVDs."""
    j, d = poses.shape[-2:]
    flat = poses.reshape(-1, j, d)
    flat_gt = poses_gt.expand(poses.shape).reshape(-1, j, d)
    return procrustes(flat_gt, flat).z.reshape(poses.shape)
