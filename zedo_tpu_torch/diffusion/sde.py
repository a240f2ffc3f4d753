"""Forward and reverse SDEs for score-based diffusion (port of
zedo_tpu/diffusion/sde.py: VP, sub-VP and VE SDEs, the reverse SDE and the
discrete DDPM schedule).

SDEs are frozen dataclasses of static hyperparameters with pure-function
methods. States x are [..., j, d], times t are x.shape[:-2]. Noise comes from
an explicit `torch.Generator`, never the global one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from zedo_tpu_torch.utils import rng

ScoreFn = Callable[..., torch.Tensor]  # (x, t, condition, mask) -> score


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Right-pad `v` with singleton axes to broadcast against `x`."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def _linspace(lo: float, hi: float, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(lo, hi, n, dtype=torch.float32, device=like.device)


def _randn(gen, shape, like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) of `shape` from `gen` (a torch.Generator, or a
    utils.rng.ShardedGenerator on a mesh)."""
    return rng.randn(gen, shape, dtype=like.dtype, device=like.device)


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

    def prior_sampling(self, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
        """A draw from the prior, shaped and placed like `like`."""
        return _randn(gen, like.shape, like)

    def _prior_sigma(self) -> float:
        return 1.0

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """Log-density [B] of z [B, ...] under the isotropic normal prior of
        std `_prior_sigma()`."""
        sigma = self._prior_sigma()
        n_dims = math.prod(z.shape[1:])
        flat = z.reshape(z.shape[0], -1)
        return (-n_dims / 2.0 * math.log(2 * math.pi * sigma ** 2)
                - (flat ** 2).sum(-1) / (2 * sigma ** 2))

    def discretize(self, x, t):
        """Euler-Maruyama discretization; dt = 1/N regardless of T, as in
        the reference."""
        dt = 1.0 / self.n
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse(self, score_fn: ScoreFn, probability_flow: bool = False) -> "ReverseSDE":
        return ReverseSDE(forward=self, score_fn=score_fn, probability_flow=probability_flow)

    def _timestep(self, t: torch.Tensor) -> torch.Tensor:
        """Index of t in the discrete tables (truncation, as astype(int32))."""
        return (t * (self.n - 1) / self.T).long()


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """Reverse-time SDE / probability-flow ODE.

    The reference multiplies the score term by 1 in both cases (the textbook
    0.5 of the ODE is absent); kept as the default, since the ZeDO pipeline
    was tuned against it. `score_coeff=0.5` gives the exact probability-flow
    ODE."""

    forward: SDE
    score_fn: ScoreFn
    probability_flow: bool = False
    score_coeff: float = 1.0

    @property
    def n(self) -> int:
        return self.forward.n

    @property
    def T(self) -> float:  # noqa: N802
        return self.forward.T

    def sde(self, x, t, condition=None, mask=None):
        drift, diffusion = self.forward.sde(x, t)
        score = self.score_fn(x, t, condition, mask)
        drift = drift - _bcast(diffusion, x) ** 2 * score * self.score_coeff
        if self.probability_flow:
            diffusion = torch.zeros_like(diffusion)
        return drift, diffusion

    def discretize(self, x, t, condition=None, mask=None):
        f, g = self.forward.discretize(x, t)
        rev_f = f - _bcast(g, x) ** 2 * self.score_fn(x, t, condition, mask) * self.score_coeff
        rev_g = torch.zeros_like(g) if self.probability_flow else g
        return rev_f, rev_g


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    """Variance-preserving (DDPM) SDE."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def discrete_betas(self, like: torch.Tensor) -> torch.Tensor:
        return _linspace(self.beta_min / self.n, self.beta_max / self.n, self.n, like)

    def alphas(self, like: torch.Tensor) -> torch.Tensor:
        return 1.0 - self.discrete_betas(like)

    def alphas_cumprod(self, like: torch.Tensor) -> torch.Tensor:
        return torch.cumprod(self.alphas(like), 0)

    def sqrt_alphas_cumprod(self, like: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.alphas_cumprod(like))

    def sqrt_1m_alphas_cumprod(self, like: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(1.0 - self.alphas_cumprod(like))

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        log_mean_coeff = (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
                          - 0.5 * t * self.beta_min)
        mean = _bcast(torch.exp(log_mean_coeff), x) * x
        return mean, torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))

    def discretize(self, x, t):
        """DDPM discretization."""
        timestep = self._timestep(t)
        beta = self.discrete_betas(x)[timestep]
        alpha = self.alphas(x)[timestep]
        return _bcast(torch.sqrt(alpha), x) * x - x, torch.sqrt(beta)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
    """Sub-VP SDE. marginal_prob's `std` is 1 - exp(2*log_mean_coeff), the
    variance-like quantity WITHOUT a square root, as in the reference: the
    score network was trained against exactly this scaling; keep it."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def alphas(self, like: torch.Tensor) -> torch.Tensor:
        """The Langevin correctors index discrete alphas for sub-VP too;
        VPSDE's table."""
        return 1.0 - _linspace(self.beta_min / self.n, self.beta_max / self.n, self.n, like)

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


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding (SMLD/NCSN) SDE."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def discrete_sigmas(self, like: torch.Tensor) -> torch.Tensor:
        return torch.exp(_linspace(math.log(self.sigma_min), math.log(self.sigma_max),
                                   self.n, like))

    def sde(self, x, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        diffusion = sigma * math.sqrt(2 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def prior_sampling(self, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
        return _randn(gen, like.shape, like) * self.sigma_max

    def _prior_sigma(self) -> float:
        return self.sigma_max

    def adjacent_sigmas(self, t):
        """(sigma, the next smaller sigma or 0 at the first step) at t."""
        timestep = self._timestep(t)
        sigmas = self.discrete_sigmas(t)
        adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                               sigmas[(timestep - 1).clamp(min=0)])
        return sigmas[timestep], adjacent

    def discretize(self, x, t):
        """SMLD discretization."""
        sigma, adjacent_sigma = self.adjacent_sigmas(t)
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adjacent_sigma ** 2)


def get_ddpm_params(beta_min=0.1, beta_max=20.0, num_scales=1000) -> dict:
    """Discrete DDPM schedule dict. The constants are computed in float64, as
    the reference does, so the 1000-factor cumprod does not accumulate f32
    rounding; only the final arrays are f32."""
    num_diffusion_timesteps = 1000
    beta_start = beta_min / num_scales
    beta_end = beta_max / num_scales
    betas64 = np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    alphas64 = 1.0 - betas64
    alphas_cumprod64 = np.cumprod(alphas64)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    return {
        "betas": f32(betas64),
        "alphas": f32(alphas64),
        "alphas_cumprod": f32(alphas_cumprod64),
        "sqrt_alphas_cumprod": f32(np.sqrt(alphas_cumprod64)),
        "sqrt_1m_alphas_cumprod": f32(np.sqrt(1.0 - alphas_cumprod64)),
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


def build_sde(name: str, *, beta_min=0.1, beta_max=20.0, sigma_min=0.01,
              sigma_max=50.0, n=1000, t_max=1.0) -> SDE:
    """The entry points' config dispatch."""
    name = name.lower()
    if name == "vpsde":
        return VPSDE(beta_min=beta_min, beta_max=beta_max, n=n, t_max=t_max)
    if name == "subvpsde":
        return SubVPSDE(beta_min=beta_min, beta_max=beta_max, n=n, t_max=t_max)
    if name == "vesde":
        return VESDE(sigma_min=sigma_min, sigma_max=sigma_max, n=n, t_max=t_max)
    raise NotImplementedError(f"SDE {name} unknown.")
