"""Sampler configuration (port of `PCSampler` from zedo_tpu/diffusion/sampling.py).

Only the static configuration is ported so far: the OIL fast path reads it
to check that the step is the deterministic probability-flow Euler update.
The predictor/corrector registry and `zedo_pc_step` wait for the generic
OIL path (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

from zedo_tpu_torch.diffusion.sde import SDE


@dataclasses.dataclass(frozen=True)
class PCSampler:
    """Static sampler configuration (mirrors config.sampling keys)."""

    sde: SDE
    predictor: str = "euler_maruyama"
    corrector: str = "none"
    snr: float = 0.16
    n_steps: int = 1
    probability_flow: bool = True
    continuous: bool = True
    denoise: bool = True
    eps: float = 1e-3
