"""Exponential moving average of a params dict (port of
zedo_tpu/diffusion/ema.py, the reference's ExponentialMovingAverage).

With the warm-up (`num_updates` >= 0) the decay of update n is
min(decay, (1 + n) / (10 + n)); the decay and its complement are computed in
f32 on the host, as the JAX package computes them on the device, so a
shadow leaf moves by exactly what JAX's moves. Each shadow leaf keeps its
dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zedo_tpu_torch.models.nn import tree_map, tree_replace, tree_to_flat


@dataclasses.dataclass
class EMAState:
    decay: float
    num_updates: int  # < 0: no warm-up (use_num_updates=False)
    shadow_params: dict


def init(params: dict, decay: float = 0.999, use_num_updates: bool = True) -> EMAState:
    if decay < 0.0 or decay > 1.0:
        raise ValueError("Decay must be between 0 and 1")
    return EMAState(decay=float(np.float32(decay)), num_updates=0 if use_num_updates else -1,
                    shadow_params=tree_map(lambda a: a.detach().clone(), params))


def update(state: EMAState, params: dict) -> EMAState:
    """shadow <- shadow - (1 - decay) * (shadow - params), out of place."""
    n = state.num_updates + 1 if state.num_updates >= 0 else state.num_updates
    decay = np.float32(state.decay)
    if n >= 0:
        decay = min(decay, np.float32(1.0 + n) / np.float32(10.0 + n))
    one_minus = np.float32(1.0) - decay
    shadow, live = tree_to_flat(state.shadow_params), tree_to_flat(params)
    new = {}
    with torch.no_grad():
        for dtype in {s.dtype for s in shadow.values()}:
            names = [k for k, s in shadow.items() if s.dtype == dtype]
            s_list = [shadow[k] for k in names]
            diff = torch._foreach_sub(s_list, [live[k].detach().to(dtype) for k in names])
            torch._foreach_mul_(diff, float(torch.tensor(float(one_minus)).to(dtype)))
            new.update(zip(names, torch._foreach_sub(s_list, diff)))
    return EMAState(decay=state.decay, num_updates=n,
                    shadow_params=tree_replace(state.shadow_params, new))


def params_of(state: EMAState) -> dict:
    """The EMA weights (the reference's copy_to, without the mutation)."""
    return state.shadow_params
