"""Small-matrix linear algebra in closed form (port of zedo_tpu/ops/linalg.py).

Batched 3x3 systems are solved by adjugate and determinant: elementwise
math on [..., 3, 3] tensors, no batched LAPACK call.
"""
from __future__ import annotations

import torch


# adjugate entry k of a row-major 3x3 matrix m: m[p] * m[q] - m[r] * m[s]
_ADJ = ((4, 8, 5, 7), (2, 7, 1, 8), (1, 5, 2, 4),
        (5, 6, 3, 8), (0, 8, 2, 6), (2, 3, 0, 5),
        (3, 7, 4, 6), (1, 6, 0, 7), (0, 4, 1, 3))


def _gather(flat: torch.Tensor, index) -> torch.Tensor:
    """flat[..., index] as one stack of views: no index tensor crosses to
    the device."""
    return torch.stack([flat[..., i] for i in index], dim=-1)


def adjugate3x3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of [..., 3, 3] matrices: its
    nine 2x2 minors in one pass (a few launches on the card, not forty)."""
    flat = m.reshape(*m.shape[:-2], 9)
    p, q, r, s = (_gather(flat, index) for index in zip(*_ADJ))
    return (p * q - r * s).reshape(m.shape)


def _det(m: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """a (ei - fh) - b (di - fg) + c (dh - eg) from the first row and the
    adjugate's first column (di - fg = -adj[1, 0], so the sum rounds as the
    cofactor expansion does)."""
    return (m[..., 0, 0] * adj[..., 0, 0] + m[..., 0, 1] * adj[..., 1, 0]) \
        + m[..., 0, 2] * adj[..., 2, 0]


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] matrices."""
    return _det(m, adjugate3x3(m))


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices via adjugate/determinant."""
    adj = adjugate3x3(m)
    return adj / _det(m, adj)[..., None, None]


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
