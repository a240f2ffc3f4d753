"""Probability-flow ODE sampler with an adaptive Dormand-Prince RK45
integrator (port of zedo_tpu/diffusion/ode.py).

Error control as scipy's RK45 and the JAX package's: per-component tolerance
atol + rtol * max(|y|, |y_new|), an RMS error norm, a step factor
0.9 * err^(-1/5) clipped to [0.2, 10], and a budget of `max_steps` steps of
7 evaluations. The state stays on the device; the host reads one number a
step, the error norm, to accept or reject it (JAX keeps the loop on the
device in a `lax.while_loop`, which torch has no counterpart of). The time
and step size are f32 host scalars, computed as the JAX loop computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from zedo_tpu_torch.diffusion.sde import SDE

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

f32 = np.float32


def rk45(f, t0: float, t1: float, y0: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-5,
         max_steps: int = 20000):
    """Integrate dy/dt = f(t, y) from t0 to t1 (t1 < t0 allowed); f maps
    (a float t, y) to dy/dt. Returns (y1, nfe)."""
    direction = 1.0 if t1 >= t0 else -1.0
    t, h, t_end = f32(t0), f32((t1 - t0) / 100.0), f32(t1)
    y, nfe = y0, 0
    while nfe < max_steps * 7:
        # clamp the final step to land exactly on t1
        if direction * (t + h - t_end) > 0:
            h = f32(t_end - t)
        ks = []
        for i in range(7):
            yi = y
            for j, aij in enumerate(_A[i]):
                yi = yi + float(h) * aij * ks[j]
            ks.append(f(float(f32(t + _C[i] * h)), yi))
        y5 = y + float(h) * sum(b * k for b, k in zip(_B5, ks) if b)
        y4 = y + float(h) * sum(b * k for b, k in zip(_B4, ks) if b)
        scale = atol + rtol * torch.maximum(y.abs(), y5.abs())
        err = f32(torch.sqrt((((y5 - y4) / scale) ** 2).mean()).item())
        nfe += 7
        factor = f32(min(max(0.9 * (err if err > 0 else 1e-10) ** -0.2, 0.2), 10.0))
        if err <= 1.0:
            t, y = f32(t + h), y5
        h = f32(h * factor)
        if direction * (t - t_end) >= 0:
            break
    return y, nfe


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
        prior draw from `gen` (on its device). Returns (x, nfe); the denoising
        step at eps, a noiseless reverse-diffusion step, counts one NFE."""
        if z is None:
            z = self.sde.prior_sampling(
                gen, torch.empty(self.shape, dtype=torch.float32, device=gen.device))

        def f(t, y):
            vec_t = torch.full((self.shape[0],), t, dtype=y.dtype, device=y.device)
            return self.drift_fn(score_fn, y, vec_t, condition, mask)

        x, nfe = rk45(f, self.sde.T, self.eps, z, rtol=self.rtol, atol=self.atol)
        if self.denoise:
            rsde = self.sde.reverse(score_fn, probability_flow=False)
            vec_eps = torch.full((self.shape[0],), self.eps, dtype=x.dtype, device=x.device)
            x = x - rsde.discretize(x, vec_eps, condition, mask)[0]
            nfe += 1
        return x, nfe
