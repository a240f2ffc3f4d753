"""Predictor-corrector samplers (port of zedo_tpu/diffusion/sampling.py):
the predictor and corrector registries, `PCSampler.zedo_pc_step` (one
step at an external time), `PCSampler.sample_loop` (the full N-step sampler
with the legacy task modes' imputation, warm start and guidance),
`make_task_mask` and `get_sampling_fn`.

`sample_loop` is one scan body a step (utils/compiled.py; JAX's one
`lax.scan`): the step reads its time from a device table (the warm start's
steps hold sde.T there) and writes the trajectory at the step counter.
`sample_loop(score_fn, ...)` runs it eagerly, the oracle;
`sample_loop_jit(model_apply, params, model_cfg, ...)` runs it compiled, a
CUDA graph replayed once a step on the card, cached by the sampler, the
model's static arguments, the guidance objective and the shapes: the params
are copied into its buffers, so new weights of the same shapes (a new EMA)
capture nothing anew.

Predictors and correctors are pure functions in registries. Noise comes
from an explicit `torch.Generator` that the caller passes in, never from the
global one, and is drawn in call order (the corrector's, then the
predictor's); JAX's threefry draws cannot be reproduced, so the noisy
updates agree with the JAX package in distribution and the deterministic
ones (probability flow, x_mean) exactly. Where the probability flow makes
an update deterministic, no noise is drawn.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from zedo_tpu_torch.diffusion.ode import ODESampler
from zedo_tpu_torch.diffusion.score import given_score, model_score
from zedo_tpu_torch.diffusion.sde import SDE, VESDE, VPSDE, ReverseSDE, SubVPSDE, _bcast, _randn
from zedo_tpu_torch.utils import compiled as compiled_lib

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

    def sample_loop(self, score_fn, gen: torch.Generator, shape, condition=None, mask=None,
                    x_init: Optional[torch.Tensor] = None, warm_start_steps: int = 0,
                    return_trajectory: bool = False, guidance_fn=None,
                    guidance_condition=None):
        """Full N-step PC sampling from sde.T down to eps, on `gen`'s device
        (or x_init's). Noise comes from `gen` in step order: the prior draw,
        then per step the corrector's, the imputation's, the predictor's and
        the imputation's again; the loop never reads the device.

        mask: [*, j, d] imputation mask (1 = known entry, imputed from
        `condition` at each step) or None. x_init: the start state (default
        a prior draw; the den task passes its noisy input). warm_start_steps:
        the first k steps run at t = sde.T. guidance_fn: optional (x, t, cond)
        -> gradient shaped like x, descended after each predictor step and
        once on the final x_mean; guidance_condition (default `condition`)
        is its cond. return_trajectory: also return the [n, *shape] states,
        the last entry the (guided) denoised x_mean. Returns x_mean when
        the sampler denoises, else x. The steps run eagerly: the oracle of
        `sample_loop_jit`."""
        return self._loop(functools.partial(given_score, score_fn=score_fn), {}, gen, shape,
                          condition, mask, x_init, warm_start_steps, return_trajectory,
                          guidance_fn, guidance_condition, compiled=False)

    def sample_loop_jit(self, model_apply, params: dict, model_cfg, gen: torch.Generator, shape,
                        condition=None, mask=None, x_init: Optional[torch.Tensor] = None,
                        warm_start_steps: int = 0, return_trajectory: bool = False,
                        guidance_fn=None, guidance_condition=None,
                        continuous: Optional[bool] = None):
        """`sample_loop` of the score of model_apply(params, model_cfg, x,
        labels, condition, mask) (get_score_fn's, continuous by default as
        the sampler), compiled: JAX's jitted `lax.scan`, keyed by the
        sampler, the model's static arguments and the shapes, the params
        copied into its buffers."""
        score = functools.partial(
            model_score, sde=self.sde, model_apply=model_apply, model_cfg=model_cfg,
            continuous=self.continuous if continuous is None else continuous)
        return self._loop(score, {"params": params}, gen, shape, condition, mask, x_init,
                          warm_start_steps, return_trajectory, guidance_fn, guidance_condition,
                          compiled=True)

    def time_table(self, warm_start_steps: int, like: torch.Tensor) -> torch.Tensor:
        """[n] the time of each step: sde.T for the warm start's steps (not
        the reference's literal 1.0: the ZeDO eval SDEs have T = 0.1), then
        the linspace from sde.T to eps."""
        timesteps = torch.linspace(self.sde.T, self.eps, self.sde.n, dtype=like.dtype,
                                   device=like.device)
        steps = torch.arange(self.sde.n, device=like.device)
        return torch.where(steps < warm_start_steps,
                           torch.as_tensor(self.sde.T, dtype=like.dtype, device=like.device),
                           timesteps)

    def _loop(self, score, model_consts: dict, gen, shape, condition, mask, x_init,
              warm_start_steps, return_trajectory, guidance_fn, guidance_condition, compiled):
        if x_init is None:
            x = self.sde.prior_sampling(
                gen, torch.empty(shape, dtype=torch.float32, device=gen.device))
        else:
            x = x_init
        if mask is not None and condition is not None:
            x = x * (1 - mask) + condition * mask
        g_cond = guidance_condition if guidance_condition is not None else condition
        consts = {**model_consts, "ts": self.time_table(warm_start_steps, x),
                  "condition": condition, "mask": mask, "guidance_condition": g_cond}
        ys = ({"trajs": torch.zeros((self.sde.n,) + tuple(x.shape), dtype=x.dtype,
                                    device=x.device)} if return_trajectory else {})
        body = functools.partial(_pc_body, sampler=self, score=score, guidance=guidance_fn,
                                 trajectory=return_trajectory)
        carry, ys = compiled_lib.scan(body, (None,) * self.sde.n, {"x": x, "x_mean": x}, consts,
                                      ys, gen, compiled=compiled)
        x, x_mean = carry["x"], carry["x_mean"]
        if guidance_fn is not None:
            last = torch.linspace(self.sde.T, self.eps, self.sde.n, dtype=x.dtype,
                                  device=x.device)[-1]
            x_mean = _guide(guidance_fn, x_mean, last.expand(shape[0]), g_cond)
        x_final = x_mean if self.denoise else x
        if return_trajectory:
            trajs = ys["trajs"]
            trajs[-1] = x_mean  # the reference's `trajs[-1] = x_mean`
            return trajs, x_final
        return x_final


def _guide(guidance_fn, x, vec_t, g_cond):
    """One descent step on the guidance objective's gradient."""
    g = guidance_fn(x, vec_t, g_cond)
    # a scalar-returning objective (get_sym_grad_fn, the reference's
    # loss-not-gradient quirk) would broadcast `x - scalar` and destroy the
    # sample
    if g.shape != x.shape:
        raise ValueError(
            f"guidance_fn must return a per-coordinate gradient shaped like x "
            f"{tuple(x.shape)}, got {tuple(g.shape)}: pass a gradient (e.g. "
            f"get_sym_gradient_fn), not a loss")
    return x - g


def _pc_body(carry, consts, ys, counter, gen, variant, *, sampler: PCSampler, score, guidance,
             trajectory: bool):
    """One step of sample_loop (utils/compiled.py's contract): corrector,
    imputation, predictor, imputation, guidance, the trajectory's entry."""
    x = carry["x"]
    score_fn = score(consts)
    vec_t = consts["ts"].index_select(0, counter).expand(x.shape[0])
    condition, mask = consts["condition"], consts["mask"]

    def impute(x, x_mean):
        if mask is None or condition is None:
            return x, x_mean
        masked_mean, std = sampler.sde.marginal_prob(condition, vec_t)
        masked = masked_mean + _randn(gen, x.shape, x) * _bcast(std, x)
        return x * (1 - mask) + masked * mask, x_mean * (1 - mask) + masked_mean * mask

    x, x_mean = get_corrector(sampler.corrector)(sampler.sde, score_fn, gen, x, vec_t, condition,
                                                 mask, sampler.snr, sampler.n_steps)
    x, x_mean = impute(x, x_mean)
    x, x_mean = get_predictor(sampler.predictor)(sampler.reverse(score_fn), gen, x, vec_t,
                                                 condition, mask)
    x, x_mean = impute(x, x_mean)
    if guidance is not None:
        x = _guide(guidance, x, vec_t, consts["guidance_condition"])
    if trajectory:
        ys["trajs"].index_copy_(0, counter, x[None])
    return {"x": x, "x_mean": x_mean}


# ----------------------------------------------------------- task masks
LIMB_JOINTS = np.array([12, 13, 15, 16, 5, 6, 2, 3])


def make_task_mask(task: str, shape: tuple, jlist: Optional[str] = None,
                   randj: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Imputation masks of the legacy task modes (1 = imputed from the
    condition): est masks the depth only; comp2d / comp3d mask the listed or
    `randj` random limb joints (comp2d the depth too); den / gen mask
    nothing. Unlike the reference, whose est branch builds this mask and
    never applies it, the mask is applied (the observed x/y stay pinned)."""
    mask = np.ones(shape, dtype=np.float32)
    rng = np.random.RandomState(seed)
    if task == "est":
        mask[..., -1] = 0
    elif task in ("comp2d", "comp3d"):
        if jlist:
            mask[:, list(map(int, jlist.split(","))), :] = 0
        elif randj:
            for b in range(shape[0]):
                mask[b, rng.choice(LIMB_JOINTS, randj, replace=False), :] = 0
        if task == "comp2d":
            mask[..., -1] = 0
    elif task in ("den", "gen"):
        mask[:] = 0
    else:
        raise ValueError(f"unknown task {task!r}")
    return mask


def get_sampling_fn(config, sde: SDE, shape, inverse_scaler, eps: float):
    """The entry points' sampler dispatch: 'pc' with any registered
    predictor and corrector, or 'ode' (the RK45 probability-flow sampler
    for `shape`). `inverse_scaler` is accepted for the JAX signature."""
    name = config.sampling.method.lower()
    if name == "ode":
        return ODESampler(sde=sde, shape=tuple(shape), denoise=config.sampling.noise_removal,
                          eps=eps)
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
