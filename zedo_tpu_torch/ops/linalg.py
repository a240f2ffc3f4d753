"""Small-matrix linear algebra in closed form (port of zedo_tpu/ops/linalg.py).

Batched 3x3 systems are solved by adjugate and determinant: elementwise
math on [..., 3, 3] tensors, no batched LAPACK call.
"""
from __future__ import annotations

import torch


def _entries(m: torch.Tensor):
    return [m[..., i, j] for i in range(3) for j in range(3)]


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] matrices."""
    a, b, c, d, e, f, g, h, i = _entries(m)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3x3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of [..., 3, 3] matrices."""
    a, b, c, d, e, f, g, h, i = _entries(m)
    adj = torch.stack([
        e * i - f * h, c * h - b * i, b * f - c * e,
        f * g - d * i, a * i - c * g, c * d - a * f,
        d * h - e * g, b * g - a * h, a * e - b * d,
    ], dim=-1)
    return adj.reshape(m.shape)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices via adjugate/determinant."""
    return adjugate3x3(m) / det3x3(m)[..., None, None]


def solve3x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b for [..., 3, 3] a and [..., 3] or [..., 3, k] b."""
    inv = inv3x3(a)
    if b.dim() == a.dim() - 1:
        return torch.einsum("...ij,...j->...i", inv, b)
    return inv @ b


def inv_intrinsics(k: torch.Tensor) -> torch.Tensor:
    """Inverse of pinhole intrinsic matrices [..., 3, 3] (general adjugate:
    datasets occasionally carry skew or normalized K)."""
    return inv3x3(k)
