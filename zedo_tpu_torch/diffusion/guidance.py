"""Guidance gradients for steering the sampler (port of
zedo_tpu/diffusion/guidance.py, the reference's match and symmetry guidance
factories). Gradients come from `torch.autograd.grad` on a detached copy of
x, so they work inside `torch.no_grad()` sampling loops too.
"""
from __future__ import annotations

import torch

# H36M-convention limb pairs
LEFT_PARENT = [12, 11, 8, 0, 4, 5]
LEFT_CHILD = [13, 12, 11, 4, 5, 6]
RIGHT_PARENT = [15, 14, 8, 0, 1, 2]
RIGHT_CHILD = [16, 15, 14, 1, 2, 3]


def _grad(loss_fn, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(xg), xg)
    return g


def get_match_grad_fn(weight: float = 1.0):
    """match_grad_fn(x, t, condition) -> [B, j, 3]: the gradient of the 2D
    match loss sum ||x_xy - condition|| with respect to x (zero in z),
    times `weight`."""

    def match_grad_fn(x, t, condition):
        del t
        return _grad(lambda v: torch.linalg.vector_norm(v[..., :2] - condition, dim=-1).sum(),
                     x) * weight

    return match_grad_fn


def symmetry_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Left/right limb-length asymmetry penalty of x [B, j, 3] (H36M-17)."""
    if x.shape[-2] < 17:
        raise ValueError(
            f"symmetry guidance requires the 17-joint H36M skeleton (got {x.shape[-2]} joints)")
    left = torch.linalg.vector_norm(x[:, LEFT_PARENT, :] - x[:, LEFT_CHILD, :], dim=-1)
    right = torch.linalg.vector_norm(x[:, RIGHT_PARENT, :] - x[:, RIGHT_CHILD, :], dim=-1)
    return ((left - right) ** 2).mean() * weight


def get_sym_grad_fn(weight: float = 1.0):
    """The reference's factory: sym_grad_fn(x, t, condition) returns the
    symmetry LOSS, a scalar, despite its name (kept for parity;
    `PCSampler.sample_loop` refuses it as guidance)."""

    def sym_grad_fn(x, t, condition=None):
        del t, condition
        return symmetry_loss(x, weight)

    return sym_grad_fn


def get_sym_gradient_fn(weight: float = 1.0):
    """The evidently intended variant: the gradient of the symmetry loss."""

    def sym_gradient_fn(x, t, condition=None):
        del t, condition
        return _grad(lambda v: symmetry_loss(v, weight), x)

    return sym_gradient_fn
