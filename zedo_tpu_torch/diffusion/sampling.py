"""Predictor-corrector sampling step (port of the predictor and corrector
registries, `PCSampler.reverse`, `PCSampler.zedo_pc_step` and
`get_sampling_fn` of zedo_tpu/diffusion/sampling.py).

Predictors and correctors are pure functions in registries. Noise comes
from an explicit `torch.Generator` that the caller passes in, never from the
global one, and is drawn in call order (the corrector's, then the
predictor's); JAX's threefry draws cannot be reproduced, so the noisy
updates agree with the JAX package in distribution and the deterministic
ones (probability flow, x_mean) exactly. Where the probability flow makes
an update deterministic, no noise is drawn.

The full N-step sampler (`sample_loop`, `make_task_mask`) and the ODE
sampler wait for the full sampling surface (ROADMAP.md Queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from zedo_tpu_torch.diffusion.sde import SDE, VESDE, VPSDE, ReverseSDE, SubVPSDE, _bcast, _randn

_PREDICTORS: dict[str, Callable] = {}
_CORRECTORS: dict[str, Callable] = {}


def _registrar(table: dict, kind: str):
    def register(fn=None, *, name=None):
        def _register(fn):
            local_name = name or fn.__name__
            if local_name in table:
                raise ValueError(f"Already registered {kind} with name: {local_name}")
            table[local_name] = fn
            return fn

        return _register(fn) if fn is not None else _register

    return register


register_predictor = _registrar(_PREDICTORS, "predictor")
register_corrector = _registrar(_CORRECTORS, "corrector")


def get_predictor(name: str) -> Callable:
    return _PREDICTORS[name]


def get_corrector(name: str) -> Callable:
    return _CORRECTORS[name]


# --------------------------------------------------------------- predictors
# Signature: (rsde, gen, x, t, condition, mask) -> (x, x_mean)


@register_predictor(name="euler_maruyama")
def euler_maruyama_predictor(rsde: ReverseSDE, gen, x, t, condition=None, mask=None):
    """With the probability flow the diffusion term is zero, so the step is
    deterministic and x == x_mean."""
    dt = -1.0 / rsde.n
    drift, diffusion = rsde.sde(x, t, condition, mask)
    x_mean = x + drift * dt
    if rsde.probability_flow:
        return x_mean, x_mean
    return x_mean + _bcast(diffusion, x) * math.sqrt(-dt) * _randn(gen, x.shape, x), x_mean


@register_predictor(name="reverse_diffusion")
def reverse_diffusion_predictor(rsde: ReverseSDE, gen, x, t, condition=None, mask=None):
    f, g = rsde.discretize(x, t, condition, mask)
    x_mean = x - f
    if rsde.probability_flow:
        return x_mean, x_mean
    return x_mean + _bcast(g, x) * _randn(gen, x.shape, x), x_mean


@register_predictor(name="ancestral_sampling")
def ancestral_sampling_predictor(rsde: ReverseSDE, gen, x, t, condition=None, mask=None):
    """VE and VP only, no probability flow."""
    sde = rsde.forward
    if rsde.probability_flow:
        raise ValueError("Probability flow not supported by ancestral sampling")
    if isinstance(sde, VESDE):
        sigma, adjacent_sigma = sde.adjacent_sigmas(t)
        score = rsde.score_fn(x, t, condition, mask)
        x_mean = x + score * _bcast(sigma ** 2 - adjacent_sigma ** 2, x)
        std = torch.sqrt(adjacent_sigma ** 2 * (sigma ** 2 - adjacent_sigma ** 2) / sigma ** 2)
        return x_mean + _bcast(std, x) * _randn(gen, x.shape, x), x_mean
    if isinstance(sde, VPSDE):
        beta = sde.discrete_betas(x)[sde._timestep(t)]
        score = rsde.score_fn(x, t, condition, mask)
        x_mean = (x + _bcast(beta, x) * score) / _bcast(torch.sqrt(1.0 - beta), x)
        return x_mean + _bcast(torch.sqrt(beta), x) * _randn(gen, x.shape, x), x_mean
    raise NotImplementedError(f"SDE class {type(sde).__name__} not supported.")


@register_predictor(name="none")
def none_predictor(rsde, gen, x, t, condition=None, mask=None):
    return x, x


# --------------------------------------------------------------- correctors
# Signature: (sde, score_fn, gen, x, t, condition, mask, snr, n_steps) -> (x, x_mean)


def _corrector_alpha(sde: SDE, t):
    if isinstance(sde, (VPSDE, SubVPSDE)):
        return sde.alphas(t)[sde._timestep(t)]
    return torch.ones_like(t)


def _batch_mean_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


@register_corrector(name="langevin")
def langevin_corrector(sde, score_fn, gen, x, t, condition, mask, snr, n_steps):
    alpha = _corrector_alpha(sde, t)
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t, condition, mask)
        noise = _randn(gen, x.shape, x)
        step_size = (snr * _batch_mean_norm(noise) / _batch_mean_norm(grad)) ** 2 * 2 * alpha
        x_mean = x + _bcast(step_size, x) * grad
        x = x_mean + _bcast(torch.sqrt(step_size * 2), x) * noise
    return x, x_mean


@register_corrector(name="ald")
def annealed_langevin_corrector(sde, score_fn, gen, x, t, condition, mask, snr, n_steps):
    """NCSN annealed Langevin dynamics."""
    alpha = _corrector_alpha(sde, t)
    std = sde.marginal_prob(x, t)[1]
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t, condition, mask)
        noise = _randn(gen, x.shape, x)
        step_size = (snr * std) ** 2 * 2 * alpha
        x_mean = x + _bcast(step_size, x) * grad
        x = x_mean + noise * _bcast(torch.sqrt(step_size * 2), x)
    return x, x_mean


@register_corrector(name="none")
def none_corrector(sde, score_fn, gen, x, t, condition, mask, snr, n_steps):
    return x, x


# ---------------------------------------------------------------- ZeDO step
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

    def reverse(self, score_fn) -> ReverseSDE:
        return self.sde.reverse(score_fn, self.probability_flow)

    def zedo_pc_step(self, score_fn, gen: torch.Generator, x, t, condition=None, mask=None):
        """One corrector + one predictor update at external time t (the ZeDO
        pc_sampler rewrite). x: [B, j, d]; t: a float, a 0-d or a [B]
        tensor. Returns (x, x_mean); callers take x_mean when denoise."""
        rsde = self.reverse(score_fn)
        vec_t = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(x.shape[0])
        x, x_mean = get_corrector(self.corrector)(
            self.sde, score_fn, gen, x, vec_t, condition, mask, self.snr, self.n_steps)
        return get_predictor(self.predictor)(rsde, gen, x, vec_t, condition, mask)


def get_sampling_fn(config, sde: SDE, shape, inverse_scaler, eps: float) -> PCSampler:
    """The entry points' sampler dispatch: 'pc' with any registered
    predictor and corrector. `shape` and `inverse_scaler` are accepted for
    the JAX signature."""
    name = config.sampling.method.lower()
    if name == "ode":
        raise NotImplementedError(
            "the ODE sampler waits for a later slice of the port (ROADMAP.md Queue 1, "
            "item 12: the full sampling surface)")
    if name != "pc":
        raise ValueError(f"Sampler name {name} unknown.")
    predictor = config.sampling.predictor.lower()
    corrector = config.sampling.corrector.lower()
    for kind, table, key in (("predictor", _PREDICTORS, predictor),
                             ("corrector", _CORRECTORS, corrector)):
        if key not in table:
            raise ValueError(f"{kind} {key!r} unknown; registered: {', '.join(table)}")
    return PCSampler(
        sde=sde, predictor=predictor, corrector=corrector, snr=config.sampling.snr,
        n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        continuous=config.training.continuous, denoise=config.sampling.noise_removal,
        eps=eps)
