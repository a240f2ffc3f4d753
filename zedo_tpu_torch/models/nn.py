"""Functional NN primitives with torch-state_dict parameter layout.

Port of zedo_tpu/models/nn.py. Parameters are nested dicts of tensors whose
keys and shapes mirror the reference model's state_dict (`weight` is
[out, in]). Mixed dtypes promote as in the JAX package (an f32 input and
bf16 weights compute in f32).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

Params = dict


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, device="cpu") -> Params:
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_dim)

    def u(*shape):
        return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1)
                * bound).to(device=device, dtype=dtype)

    return {"weight": u(out_dim, in_dim), "bias": u(out_dim)}


def init_group_norm(num_channels: int, dtype=torch.float32, device="cpu") -> Params:
    return {"weight": torch.ones(num_channels, dtype=dtype, device=device),
            "bias": torch.zeros(num_channels, dtype=dtype, device=device)}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ W^T + b with W [out, in] (torch layout)."""
    dt = torch.promote_types(x.dtype, p["weight"].dtype)
    return x.to(dt) @ p["weight"].to(dt).T + p["bias"].to(dt)


@functools.lru_cache(maxsize=16)
def _group_indicator_np(c: int, g: int) -> np.ndarray:
    """[C, G] one-hot group membership / group size."""
    m = np.zeros((c, g), np.float32)
    size = c // g
    for i in range(g):
        m[i * size:(i + 1) * size, i] = 1.0 / size
    return m


@functools.lru_cache(maxsize=16)
def _group_indicator(c: int, g: int, device: torch.device) -> torch.Tensor:
    """The indicator on `device`, copied there once: a host-to-device copy
    of pageable memory blocks the host until the device has caught up, which
    in a step loop (the generic OIL path's adapters) would be one host sync
    per GroupNorm."""
    return torch.as_tensor(_group_indicator_np(c, g), device=device)


def group_norm(p: Params, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis of [..., C] (torch semantics: biased
    two-pass variance per group of C/num_groups contiguous channels, then
    the per-channel affine), computed in f32 through the group-indicator
    products of the JAX version."""
    c = x.shape[-1]
    ind = _group_indicator(c, num_groups, x.device)
    bcast = ind.T * (c // num_groups)
    xf = x.float()
    centered = xf - (xf @ ind) @ bcast
    rstd = torch.rsqrt((centered * centered) @ ind + eps) @ bcast
    xn = (centered * rstd).to(x.dtype)
    return xn * p["weight"] + p["bias"]


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)
