"""Sampler configuration (port of `PCSampler` and `get_sampling_fn` from
zedo_tpu/diffusion/sampling.py).

Only the static configuration is ported so far: the OIL fast path reads it
to check that the step is the deterministic probability-flow Euler update.
The predictor/corrector registry and `zedo_pc_step` wait for the generic
OIL path, and the ODE sampler for the full sampling surface (ROADMAP.md
Queue 1, items 4 and 12).
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


_LATER = "waits for a later slice of the port (ROADMAP.md Queue 1, item {})"


def get_sampling_fn(config, sde: SDE, shape, inverse_scaler, eps: float) -> PCSampler:
    """The entry points' sampler dispatch: 'pc' with the euler_maruyama
    predictor and no corrector, the sampler of every shipped configuration.
    `shape` and `inverse_scaler` are accepted for the JAX signature."""
    name = config.sampling.method.lower()
    if name == "ode":
        raise NotImplementedError("the ODE sampler " + _LATER.format(12))
    if name != "pc":
        raise ValueError(f"Sampler name {name} unknown.")
    predictor = config.sampling.predictor.lower()
    corrector = config.sampling.corrector.lower()
    if (predictor, corrector) != ("euler_maruyama", "none"):
        raise NotImplementedError(
            f"predictor {predictor!r} with corrector {corrector!r} " + _LATER.format(4))
    return PCSampler(
        sde=sde, predictor=predictor, corrector=corrector, snr=config.sampling.snr,
        n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        continuous=config.training.continuous, denoise=config.sampling.noise_removal,
        eps=eps)
