"""Exponential moving average of a params dict (port of
zedo_tpu/diffusion/ema.py, the reference's ExponentialMovingAverage).

With the warm-up (`num_updates` >= 0) the decay of update n is
min(decay, (1 + n) / (10 + n)). As in the JAX package, `num_updates` is an
int32 device tensor and the decay and its complement are computed on the
device in f32 (a division of two tensors, correctly rounded on the CPU and
the card alike), so a shadow leaf moves by exactly what JAX's moves and a
compiled train step reads no host value. Each shadow leaf keeps its dtype:
the complement is rounded to it before the product.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zedo_tpu_torch.models.nn import tree_map, tree_replace, tree_to_flat


@dataclasses.dataclass
class EMAState:
    decay: float
    num_updates: torch.Tensor  # int32, on the shadows' device; < 0: no warm-up
    shadow_params: dict

    def __post_init__(self):
        if not isinstance(self.num_updates, torch.Tensor):
            leaves = list(tree_to_flat(self.shadow_params).values())
            device = leaves[0].device if leaves else "cpu"
            self.num_updates = torch.tensor(int(self.num_updates), dtype=torch.int32,
                                            device=device)


def init(params: dict, decay: float = 0.999, use_num_updates: bool = True) -> EMAState:
    if decay < 0.0 or decay > 1.0:
        raise ValueError("Decay must be between 0 and 1")
    return EMAState(decay=float(np.float32(decay)), num_updates=0 if use_num_updates else -1,
                    shadow_params=tree_map(lambda a: a.detach().clone(), params))


def _next(state: EMAState):
    """(num_updates after this update, 1 - its decay) as f32 device values."""
    count = state.num_updates
    n = torch.where(count >= 0, count + 1, count)
    decay = torch.full((), state.decay, dtype=torch.float32, device=count.device)
    warm = (n + 1).to(torch.float32) / (n + 10).to(torch.float32)
    decay = torch.where(n >= 0, torch.minimum(decay, warm), decay)
    return n, 1.0 - decay


def _moved(state: EMAState, params: dict, in_place: bool) -> dict:
    n, one_minus = _next(state)
    shadow, live = tree_to_flat(state.shadow_params), tree_to_flat(params)
    new = {}
    with torch.no_grad():
        for dtype in {s.dtype for s in shadow.values()}:
            names = [k for k, s in shadow.items() if s.dtype == dtype]
            s_list = [shadow[k] for k in names]
            diff = torch._foreach_sub(s_list, [live[k].detach().to(dtype) for k in names])
            torch._foreach_mul_(diff, one_minus.to(dtype))
            if in_place:
                torch._foreach_sub_(s_list, diff)
            else:
                new.update(zip(names, torch._foreach_sub(s_list, diff)))
    return n, new


def update(state: EMAState, params: dict) -> EMAState:
    """shadow <- shadow - (1 - decay) * (shadow - params), out of place."""
    n, new = _moved(state, params, in_place=False)
    return EMAState(decay=state.decay, num_updates=n,
                    shadow_params=tree_replace(state.shadow_params, new))


def update_(state: EMAState, params: dict) -> None:
    """`update` in place: the shadows and the count are written where they
    are (the train step's donated buffers)."""
    n, _ = _moved(state, params, in_place=True)
    state.num_updates.copy_(n)


def params_of(state: EMAState) -> dict:
    """The EMA weights (the reference's copy_to, without the mutation)."""
    return state.shadow_params
