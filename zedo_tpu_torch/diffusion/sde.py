"""Forward SDEs for score-based diffusion (port of the base class and the
sub-VP SDE of zedo_tpu/diffusion/sde.py, the SDE that ZeDO runs).

SDEs are frozen dataclasses of static hyperparameters with pure-function
methods. States x are [..., j, d], times t are x.shape[:-2].
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Right-pad `v` with singleton axes to broadcast against `x`."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base class; subclasses define drift/diffusion and marginals."""

    n: int = 1000  # discretization steps (reference `N`)
    t_max: float = 1.0  # end time (reference `T`; ZeDO uses 0.1)

    @property
    def T(self) -> float:  # noqa: N802 — reference API name
        return self.t_max

    def sde(self, x, t):
        raise NotImplementedError

    def marginal_prob(self, x, t):
        raise NotImplementedError

    def discretize(self, x, t):
        """Euler-Maruyama discretization; dt = 1/N regardless of T, as in
        the reference."""
        dt = 1.0 / self.n
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
    """Sub-VP SDE. marginal_prob's `std` is 1 - exp(2*log_mean_coeff), the
    variance-like quantity WITHOUT a square root, as in the reference: the
    score network was trained against exactly this scaling; keep it."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        drift = -0.5 * _bcast(beta_t, x) * x
        discount = 1.0 - torch.exp(
            -2.0 * self.beta_min * t - (self.beta_max - self.beta_min) * t ** 2)
        return drift, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        log_mean_coeff = (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
                          - 0.5 * t * self.beta_min)
        mean = _bcast(torch.exp(log_mean_coeff), x) * x
        std = 1.0 - torch.exp(2.0 * log_mean_coeff)
        return mean, std


def build_sde(name: str, *, beta_min=0.1, beta_max=20.0, sigma_min=0.01,
              sigma_max=50.0, n=1000, t_max=1.0) -> SDE:
    """The entry points' config dispatch. Only the sub-VP SDE, the one every
    shipped configuration names, is ported."""
    name = name.lower()
    if name == "subvpsde":
        return SubVPSDE(beta_min=beta_min, beta_max=beta_max, n=n, t_max=t_max)
    if name in ("vpsde", "vesde"):
        raise NotImplementedError(
            f"SDE {name} waits for a later slice of the port (ROADMAP.md Queue 1, "
            "item 4: VP/VE SDEs and the predictor/corrector registries)")
    raise NotImplementedError(f"SDE {name} unknown.")
