"""Probability-flow ODE sampler with an adaptive Dormand-Prince RK45
integrator (port of zedo_tpu/diffusion/ode.py).

Error control as scipy's RK45 and the JAX package's: per-component tolerance
atol + rtol * max(|y|, |y_new|), an RMS error norm, a step factor
0.9 * err^(-1/5) clipped to [0.2, 10], and a budget of `max_steps` steps of
7 evaluations. As JAX's `_RKState`, the integrator's time and step size are
f32 device scalars and its evaluation count an int32 one; accepting a step,
clamping the last one and the step factor are `torch.where`s on the device.
The loop is a `utils.compiled.while_loop` (JAX's `lax.while_loop`): its body
masked once the integration is done, run in chunks of `CHUNK` steps, the
host reading whether to go on once a chunk. `ODESampler.sample_jit` replays
a chunk as one CUDA graph on the card; `ODESampler.sample` and `rk45` run
the same steps eagerly, the oracle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from zedo_tpu_torch.diffusion.score import given_score, model_score
from zedo_tpu_torch.diffusion.sde import SDE
from zedo_tpu_torch.utils import compiled as compiled_lib

_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]

# steps of a chunk: the host reads once per chunk whether to go on, and the
# last chunk runs up to CHUNK - 1 masked steps past the end
CHUNK = 8


def _rk45_body(carry, consts, ys, counter, generator, variant, *, f, t1: float, rtol: float,
               atol: float, direction: float):
    """One Dormand-Prince step (utils/compiled.py's contract): f(consts, t,
    y) -> dy/dt with t a 0-d device tensor."""
    t, y, h, nfe = carry["t"], carry["y"], carry["h"], carry["nfe"]
    # clamp the final step to land exactly on t1
    h = torch.where(direction * (t + h - t1) > 0, t1 - t, h)
    ks = []
    for i in range(7):
        yi = y
        for j, aij in enumerate(_A[i]):
            yi = yi + h * aij * ks[j]
        ks.append(f(consts, t + float(_C[i]) * h, yi))
    y5 = y + h * sum(b * k for b, k in zip(_B5, ks) if b)
    y4 = y + h * sum(b * k for b, k in zip(_B4, ks) if b)
    scale = atol + rtol * torch.maximum(y.abs(), y5.abs())
    err = torch.sqrt((((y5 - y4) / scale) ** 2).mean())
    accept = err <= 1.0
    factor = torch.clamp(0.9 * torch.where(err > 0, err, 1e-10) ** -0.2, 0.2, 10.0)
    return {"t": torch.where(accept, t + h, t), "y": torch.where(accept, y5, y),
            "h": h * factor, "nfe": nfe + 7}


def _rk45_going(carry, consts, *, t1: float, direction: float, max_nfe: int):
    """JAX's cond: not yet at t1 and within the evaluation budget."""
    return (direction * (carry["t"] - t1) < 0) & (carry["nfe"] < max_nfe)


def _rk45(f, consts: dict, t0: float, t1: float, y0: torch.Tensor, rtol: float, atol: float,
          max_steps: int, compiled: bool):
    direction = 1.0 if t1 >= t0 else -1.0

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=y0.device)

    carry = {"t": scalar(t0), "y": y0, "h": scalar((t1 - t0) / 100.0),
             "nfe": scalar(0, torch.int32)}
    body = functools.partial(_rk45_body, f=f, t1=t1, rtol=rtol, atol=atol, direction=direction)
    going = functools.partial(_rk45_going, t1=t1, direction=direction, max_nfe=max_steps * 7)
    out = compiled_lib.while_loop(going, body, carry, consts, chunk=CHUNK, compiled=compiled)
    return out["y"], out["nfe"]


def _call_f(consts, t, y, *, f):
    return f(t, y)


def rk45(f, t0: float, t1: float, y0: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-5,
         max_steps: int = 20000):
    """Integrate dy/dt = f(t, y) from t0 to t1 (t1 < t0 allowed), eagerly;
    f maps (t, a 0-d f32 device tensor, y) to dy/dt. Returns (y1, nfe), nfe
    a 0-d int32 device tensor."""
    return _rk45(functools.partial(_call_f, f=f), {}, t0, t1, y0, rtol, atol, max_steps,
                 compiled=False)


def _drift(consts, t, y, *, sampler: "ODESampler", score):
    """The probability-flow drift at t (broadcast over the rows) of the
    score built from consts."""
    vec_t = t.expand(y.shape[0])
    return sampler.drift_fn(score(consts), y, vec_t, consts["condition"], consts["mask"])


@dataclasses.dataclass(frozen=True)
class ODESampler:
    """Probability-flow ODE sampler."""

    sde: SDE
    shape: tuple
    denoise: bool = False
    rtol: float = 1e-5
    atol: float = 1e-5
    eps: float = 1e-3
    # 1.0 reproduces the reference dynamics (its probability flow lacks the
    # textbook 0.5 on the score term); 0.5 is the exact probability-flow ODE
    score_coeff: float = 1.0

    def drift_fn(self, score_fn, x, t, condition=None, mask=None):
        """The reverse ODE's drift."""
        rsde = dataclasses.replace(self.sde.reverse(score_fn, probability_flow=True),
                                   score_coeff=self.score_coeff)
        return rsde.sde(x, t, condition, mask)[0]

    def sample(self, score_fn, gen: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None, condition=None, mask=None):
        """Integrate the probability-flow ODE from sde.T to eps, from z or a
        prior draw from `gen` (on its device). Returns (x, nfe), nfe an int
        (one host read); the denoising step at eps, a noiseless
        reverse-diffusion step, counts one NFE. The steps run eagerly: the
        oracle of `sample_jit`."""
        return self._sample(functools.partial(given_score, score_fn=score_fn), {}, gen, z,
                            condition, mask, compiled=False)

    def sample_jit(self, model_apply, params: dict, model_cfg,
                   gen: Optional[torch.Generator] = None, z: Optional[torch.Tensor] = None,
                   condition=None, mask=None, continuous: bool = True):
        """`sample` of the score of model_apply(params, model_cfg, x, labels,
        condition, mask) (get_score_fn's), compiled: JAX's jitted
        `lax.while_loop`, keyed by the sampler, the model's static arguments
        and the shapes, the params copied into its buffers."""
        score = functools.partial(model_score, sde=self.sde, model_apply=model_apply,
                                  model_cfg=model_cfg, continuous=continuous)
        return self._sample(score, {"params": params}, gen, z, condition, mask, compiled=True)

    def _sample(self, score, model_consts, gen, z, condition, mask, compiled):
        if z is None:
            z = self.sde.prior_sampling(
                gen, torch.empty(self.shape, dtype=torch.float32, device=gen.device))
        consts = {**model_consts, "condition": condition, "mask": mask}
        f = functools.partial(_drift, sampler=self, score=score)
        x, nfe = _rk45(f, consts, self.sde.T, self.eps, z, self.rtol, self.atol, 20000,
                       compiled)
        nfe = int(nfe)
        if self.denoise:
            score_fn = score(consts)
            rsde = self.sde.reverse(score_fn, probability_flow=False)
            vec_eps = torch.full((self.shape[0],), self.eps, dtype=x.dtype, device=x.device)
            x = x - rsde.discretize(x, vec_eps, condition, mask)[0]
            nfe += 1
        return x, nfe
