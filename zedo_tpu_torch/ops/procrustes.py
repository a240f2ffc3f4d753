"""Procrustes alignment (protocol 2, PA-MPJPE), batched.

Port of zedo_tpu/ops/procrustes.py. The [..., j, 3] batch is folded into
one batch of 3x3 cross-covariances whose SVDs are one `torch.linalg.svd`
call, as `jnp.linalg.svd` is one XLA op there.

The JAX products run at `Precision.HIGHEST`. Here every product of the
alignment is a broadcast multiply and a sum over a 3- or j-long axis, never
a matmul, so no TF32 setting of the process can round its operands.

`align_to_gt_batched` is compiled (JAX jits it): on the card the products
before the SVD run as one CUDA graph and those after it as another
(utils/compiled.py), and the SVD runs between them on the card, eagerly:
cuSOLVER's batched SVD checks its convergence flags on the host, which
stream capture refuses. `aligned_batched` is that alignment with the
caller's own products before and after it (the evaluation's joint subset
and errors), in the same two graphs. `procrustes` is the same stages run
eagerly, the oracle.

`R = V U^T` and `trace(s)` do not depend on the signs that an SVD picks for
its singular vectors while the singular values are distinct, so LAPACK and
cuSOLVER give the same alignment. `reflection="best"` applies no
determinant fix, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zedo_tpu_torch.utils import compiled as compiled_lib


class ProcrustesResult(NamedTuple):
    d: torch.Tensor  # normalized residual [...]
    z: torch.Tensor  # transformed B [..., n, dim]
    rotation: torch.Tensor  # [..., dim, dim]; Z = scale * B @ rotation + translation
    scale: torch.Tensor  # [...]
    translation: torch.Tensor  # [..., dim]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., m, k] @ [..., k, n] in full f32, as a broadcast multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def centred(a: torch.Tensor, b: torch.Tensor) -> dict:
    """procrustes' products before its SVD: the means, norms and centred,
    normalized b, and the [..., dim, dim] cross-covariance `m`."""
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
    return {"a_bar": a_bar, "b_bar": b_bar, "b0": b0, "ss_x": ss_x, "ss_y": ss_y,
            "a_norm": a_norm, "b_norm": b_norm, "m": m}


def solved(c: dict, svd, scaling: bool = True, reflection="best") -> ProcrustesResult:
    """procrustes' products after its SVD: `c` from `centred`, `svd` the
    (u, s, vt) of c["m"]."""
    u, s, vt = svd
    v = vt.transpose(-1, -2)
    r = _mm(v, u.transpose(-1, -2))

    if reflection != "best":
        flip = (torch.linalg.det(r) < 0) != bool(reflection)
        signs = torch.ones(s.shape, dtype=s.dtype, device=s.device)
        signs[..., -1] = torch.where(flip, -1.0, 1.0).to(s.dtype)
        v = v * signs[..., None, :]
        s = s * signs
        r = _mm(v, u.transpose(-1, -2))

    a_bar, b0, a_norm, b_norm = c["a_bar"], c["b0"], c["a_norm"], c["b_norm"]
    s_trace = s.sum(-1)
    if scaling:
        scale = s_trace * a_norm / b_norm
        d = 1 - s_trace ** 2
        z = (a_norm * s_trace)[..., None, None] * _mm(b0, r) + a_bar
    else:
        scale = torch.ones_like(s_trace)
        d = 1 + c["ss_y"] / c["ss_x"] - 2 * s_trace * b_norm / a_norm
        z = b_norm[..., None, None] * _mm(b0, r) + a_bar

    translation = (a_bar - scale[..., None, None] * _mm(c["b_bar"], r))[..., 0, :]
    return ProcrustesResult(d=d, z=z, rotation=r, scale=scale, translation=translation)


def procrustes(a: torch.Tensor, b: torch.Tensor, scaling: bool = True,
               reflection="best") -> ProcrustesResult:
    """Least-squares similarity transform of `b` onto `a`.

    a, b: [..., n, dim] point sets of equal dim (the reference's dim_y <
    dim_x zero-padding branch is unreachable from every caller and not
    supported). Leading axes are a batch. `scaling` and `reflection` are
    Python values: "best" takes the SVD's rotation as it is, True or False
    forces a reflection or a proper rotation per sample."""
    c = centred(a, b)
    return solved(c, torch.linalg.svd(c["m"]), scaling, reflection)


def align_to_gt(pose: torch.Tensor, pose_gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-align `pose` [j, 3] to `pose_gt` [j, 3]."""
    return procrustes(pose_gt, pose).z


def centred_batched(poses: torch.Tensor, poses_gt: torch.Tensor) -> dict:
    """`centred` of the gt and the poses [..., j, 3] folded into one batch."""
    j, d = poses.shape[-2:]
    flat = poses.reshape(-1, j, d)
    flat_gt = poses_gt.expand(poses.shape).reshape(-1, j, d)
    return centred(flat_gt, flat)


def _align_first(carry, consts, ys, counter, generator, variant, *, inputs):
    return centred_batched(*inputs(consts))


def _align_second(carry, consts, ys, counter, generator, variant, *, inputs, epilogue):
    poses, poses_gt = inputs(consts)
    aligned = solved(consts["centred"], consts["svd"]).z.reshape(poses.shape)
    return epilogue(consts, aligned, poses_gt)


def aligned_batched(consts: dict, inputs, epilogue) -> dict:
    """The compiled alignment: inputs(consts) -> (poses, poses_gt)
    [..., j, 3] in the first graph, the poses aligned to the gt (one batch
    of 3x3 SVDs between the graphs), and epilogue(consts, aligned,
    poses_gt) -> a dict of tensors in the second graph, returned. inputs
    and epilogue are static: module-level functions or their partials."""
    c, _ = compiled_lib.step(functools.partial(_align_first, inputs=inputs), None, consts,
                             compiled=True)
    out, _ = compiled_lib.step(
        functools.partial(_align_second, inputs=inputs, epilogue=epilogue), None,
        {**consts, "centred": c, "svd": tuple(torch.linalg.svd(c["m"]))}, compiled=True)
    return out


def _given(consts):
    return consts["poses"], consts["poses_gt"]


def _aligned(consts, aligned, poses_gt):
    return {"z": aligned}


def align_to_gt_batched(poses: torch.Tensor, poses_gt: torch.Tensor) -> torch.Tensor:
    """Alignment over any leading batch axes: poses, poses_gt [..., j, 3] ->
    aligned poses [..., j, 3], one batch of 3x3 SVDs, compiled (JAX's
    jitted function)."""
    return aligned_batched({"poses": poses, "poses_gt": poses_gt}, _given, _aligned)["z"]
