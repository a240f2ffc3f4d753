"""Score-function wrappers: turn a raw denoiser into a time-dependent score
(port of zedo_tpu/diffusion/score.py).

VP / sub-VP with continuous labels (the shipped configuration): labels are
t*999 and score = -model(x, labels) / std with std = marginal_prob(0, t)[1]
(for sub-VP that std is 1 - exp(2*lmc), not square-rooted: sde.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from zedo_tpu_torch.diffusion.sde import SDE, VESDE, VPSDE, SubVPSDE, _bcast

# model_fn(x, labels, condition, mask) -> raw network output
ModelFn = Callable[..., torch.Tensor]

CONTINUOUS_LABEL_SCALE = 999.0  # model-facing labels are t*999 for continuous SDEs


def split_score_fn(sde: SDE, model_fn: ModelFn, continuous: bool = False):
    """get_score_fn in its two halves:

      eval_fn(x, t, condition, mask) -> raw network output (one NFE), and
      score_from_out(out, x, t)      -> the score (the per-step std).

    A caller that reuses the network output across steps (OILConfig.
    score_reuse on the generic path) re-runs only score_from_out, so the
    reused output is divided by the CURRENT std, as on the fast path."""
    if isinstance(sde, (VPSDE, SubVPSDE)):
        continuous_labels = continuous or isinstance(sde, SubVPSDE)

        def eval_fn(x, t, condition=None, mask=None):
            labels = t * CONTINUOUS_LABEL_SCALE if continuous_labels else t * (sde.n - 1)
            return model_fn(x, labels, condition, mask)

        def score_from_out(out, x, t):
            if continuous_labels:
                std = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                std = sde.sqrt_1m_alphas_cumprod(x)[(t * (sde.n - 1)).long()]
            return -out / _bcast(std, x)

    elif isinstance(sde, VESDE):

        def eval_fn(x, t, condition=None, mask=None):
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.n - 1)).long()
            return model_fn(x, labels, condition, mask)

        def score_from_out(out, x, t):
            return out  # VE models output the score directly

    else:
        raise NotImplementedError(f"SDE class {type(sde).__name__} not supported.")

    return eval_fn, score_from_out


def get_score_fn(sde: SDE, model_fn: ModelFn, continuous: bool = False):
    """Wrap `model_fn` so that its output is the score."""
    eval_fn, score_from_out = split_score_fn(sde, model_fn, continuous)

    def score_fn(x, t, condition=None, mask=None):
        return score_from_out(eval_fn(x, t, condition, mask), x, t)

    return score_fn


def given_score(consts, *, score_fn):
    """A compiled body's score: a score function given as it is (the eager
    samplers' `score_fn`, a closure over its weights)."""
    return score_fn


def model_score(consts, *, sde: SDE, model_apply, model_cfg, continuous: bool):
    """A compiled body's score: get_score_fn of model_apply(params,
    model_cfg, x, labels, condition, mask) over the weights in
    consts["params"], which the compiled call copies into its buffers (new
    weights of the same shapes replay the same graphs)."""
    params = consts["params"]

    def model_fn(x, labels, condition, mask):
        return model_apply(params, model_cfg, x, labels, condition, mask)

    return get_score_fn(sde, model_fn, continuous=continuous)
