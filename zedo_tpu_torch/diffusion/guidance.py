"""Guidance gradients for steering the sampler (port of
zedo_tpu/diffusion/guidance.py, the reference's match and symmetry guidance
factories). Gradients come from `torch.autograd.grad` on a detached copy of
x, so they work inside `torch.no_grad()` sampling loops too. The gradient
factories return partials of module-level functions: a compiled sampler
(`PCSampler.sample_loop_jit`) keys its graphs by the objective, and a
partial built anew with the same weight is the same objective.
"""
from __future__ import annotations

import functools

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


def _match_grad(x, t, condition, *, weight: float):
    del t
    return _grad(lambda v: torch.linalg.vector_norm(v[..., :2] - condition, dim=-1).sum(),
                 x) * weight


def get_match_grad_fn(weight: float = 1.0):
    """match_grad_fn(x, t, condition) -> [B, j, 3]: the gradient of the 2D
    match loss sum ||x_xy - condition|| with respect to x (zero in z),
    times `weight`."""
    return functools.partial(_match_grad, weight=weight)


@functools.lru_cache(maxsize=None)
def _limbs(device: torch.device) -> tuple:
    """The limb pairs' joint indices as tensors on `device`, made once: a
    list index would be copied from the host at every call, which a CUDA
    graph's capture refuses."""
    return tuple(torch.tensor(j, device=device)
                 for j in (LEFT_PARENT, LEFT_CHILD, RIGHT_PARENT, RIGHT_CHILD))


def symmetry_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Left/right limb-length asymmetry penalty of x [B, j, 3] (H36M-17)."""
    if x.shape[-2] < 17:
        raise ValueError(
            f"symmetry guidance requires the 17-joint H36M skeleton (got {x.shape[-2]} joints)")
    lp, lc, rp, rc = _limbs(x.device)
    left = torch.linalg.vector_norm(x[:, lp, :] - x[:, lc, :], dim=-1)
    right = torch.linalg.vector_norm(x[:, rp, :] - x[:, rc, :], dim=-1)
    return ((left - right) ** 2).mean() * weight


def get_sym_grad_fn(weight: float = 1.0):
    """The reference's factory: sym_grad_fn(x, t, condition) returns the
    symmetry LOSS, a scalar, despite its name (kept for parity;
    `PCSampler.sample_loop` refuses it as guidance)."""

    def sym_grad_fn(x, t, condition=None):
        del t, condition
        return symmetry_loss(x, weight)

    return sym_grad_fn


def _sym_gradient(x, t, condition=None, *, weight: float):
    del t, condition
    return _grad(lambda v: symmetry_loss(v, weight), x)


def get_sym_gradient_fn(weight: float = 1.0):
    """The evidently intended variant: the gradient of the symmetry loss."""
    return functools.partial(_sym_gradient, weight=weight)
