"""Score-matching losses and the train step (port of
zedo_tpu/diffusion/losses.py, the reference's losses.py on optax).

The optimizer is the reference's optimize_fn and the JAX package's optax
chain: the learning rate warmed up linearly from the step counter BEFORE its
increment (the first step runs at lr 0), the global norm of the trainable
gradients clipped, coupled L2 weight decay (torch Adam's `weight_decay`
adds wd * param to the raw gradient) and Adam(beta1, 0.999, eps).

Params are dicts of tensors with the reference's state_dict names. A train
step updates the TrainState in place: the trainable leaves (grad_mask, minus
the buffers `sigmas` and the fourier `gauss_proj.W`) get gradients, the
others never move and keep no Adam moments. Every random draw, (t, z) and
the model's dropout, comes from the `torch.Generator` passed to the loss.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from zedo_tpu_torch.diffusion import ema as ema_lib
from zedo_tpu_torch.diffusion.score import get_score_fn
from zedo_tpu_torch.diffusion.sde import SDE, VESDE, VPSDE, _bcast, _randn
from zedo_tpu_torch.models.nn import tree_map, tree_to_flat
from zedo_tpu_torch.utils import rng

# model_apply(params, x, labels, condition, mask, train=False, generator=None)
ModelApply = Callable[..., torch.Tensor]


def _uniform(gen, n: int, like: torch.Tensor) -> torch.Tensor:
    return rng.rand(gen, (n,), dtype=like.dtype, device=like.device)


def _randint(gen, high: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return rng.randint(gen, high, (n,), device=like.device)


def lr_schedule(config) -> Callable[[int], float]:
    """The learning rate of step `step` (linear warm-up, then flat)."""
    warmup, lr = config.optim.warmup, config.optim.lr

    def schedule(step: int) -> float:
        return lr * min(step / warmup, 1.0) if warmup > 0 else lr

    return schedule


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optax chain of the JAX package as torch calls: `init` builds the
    Adam over a list of leaves, `step` clips their gradients, sets the
    scheduled learning rate and steps."""

    schedule: Callable[[int], float]
    grad_clip: float
    weight_decay: float
    beta1: float
    eps: float

    def init(self, leaves: list) -> torch.optim.Adam:
        fused = bool(leaves) and leaves[0].device.type == "cuda"
        return torch.optim.Adam(leaves, lr=self.schedule(0), betas=(self.beta1, 0.999),
                                eps=self.eps, weight_decay=self.weight_decay,
                                fused=fused or None)

    def step(self, adam: torch.optim.Adam, trainable: list, step: int,
             grad_norm: Optional[Callable[[list], torch.Tensor]] = None) -> None:
        """grad_norm: the global norm of the leaves' gradients where it is not
        their own (tensor-parallel shards), clipped as clip_grad_norm_ does."""
        if self.grad_clip >= 0:
            if grad_norm is None:
                torch.nn.utils.clip_grad_norm_(trainable, self.grad_clip)
            else:
                grads = [p.grad for p in trainable]
                coef = torch.clamp(self.grad_clip / (grad_norm(grads) + 1e-6), max=1.0)
                torch._foreach_mul_(grads, coef)
        for group in adam.param_groups:
            group["lr"] = self.schedule(step)
        adam.step()


def get_optimizer(config) -> Optimizer:
    if config.optim.optimizer != "Adam":
        raise NotImplementedError(f"Optimizer {config.optim.optimizer} not supported yet!")
    return Optimizer(schedule=lr_schedule(config), grad_clip=float(config.optim.grad_clip),
                     weight_decay=float(config.optim.get("weight_decay", 0) or 0),
                     beta1=float(config.optim.beta1), eps=float(config.optim.eps))


def _reduce_op(reduce_mean: bool):
    if reduce_mean:
        return lambda x: x.mean(-1)
    return lambda x: 0.5 * x.sum(-1)


def get_sde_loss_fn(sde: SDE, model_apply: ModelApply, train: bool, reduce_mean: bool = False,
                    continuous: bool = True, likelihood_weighting: bool = False,
                    eps: float = 1e-5):
    """Continuous denoising score matching: loss_fn(params, gen, batch,
    condition=None, mask=None) -> scalar, with t ~ U(eps, T) and z ~ N(0, 1)
    drawn from `gen` (t first)."""
    reduce_op = _reduce_op(reduce_mean)

    def loss_fn(params, gen, batch, condition=None, mask=None):
        def model_fn(x, labels, cond, msk):
            return model_apply(params, x, labels, cond, msk, train=train, generator=gen)

        score_fn = get_score_fn(sde, model_fn, continuous=continuous)
        t = _uniform(gen, batch.shape[0], batch) * (sde.T - eps) + eps
        z = _randn(gen, batch.shape, batch)
        mean, std = sde.marginal_prob(batch, t)
        score = score_fn(mean + _bcast(std, batch) * z, t, condition, mask)
        if not likelihood_weighting:
            losses = torch.square(score * _bcast(std, batch) + z)
            losses = reduce_op(losses.reshape(losses.shape[0], -1))
        else:
            g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
            losses = torch.square(score + z / _bcast(std, batch))
            losses = reduce_op(losses.reshape(losses.shape[0], -1)) * g2
        return losses.mean()

    return loss_fn


def get_smld_loss_fn(vesde: VESDE, model_apply: ModelApply, train: bool,
                     reduce_mean: bool = False):
    """The discrete SMLD/NCSN loss (labels, then noise, from `gen`)."""
    if not isinstance(vesde, VESDE):
        raise ValueError("SMLD training only works for VESDEs.")
    reduce_op = _reduce_op(reduce_mean)

    def loss_fn(params, gen, batch, condition=None, mask=None):
        labels = _randint(gen, vesde.n, batch.shape[0], batch)
        sigmas = torch.flip(vesde.discrete_sigmas(batch), (0,))[labels]
        noise = _randn(gen, batch.shape, batch) * _bcast(sigmas, batch)
        score = model_apply(params, noise + batch, labels, condition, mask, train=train,
                            generator=gen)
        target = -noise / _bcast(sigmas ** 2, batch)
        losses = torch.square(score - target)
        return (reduce_op(losses.reshape(losses.shape[0], -1)) * sigmas ** 2).mean()

    return loss_fn


def get_ddpm_loss_fn(vpsde: VPSDE, model_apply: ModelApply, train: bool,
                     reduce_mean: bool = True):
    """The discrete DDPM loss (labels, then noise, from `gen`)."""
    if not isinstance(vpsde, VPSDE):
        raise ValueError("DDPM training only works for VPSDEs.")
    reduce_op = _reduce_op(reduce_mean)

    def loss_fn(params, gen, batch, condition=None, mask=None):
        labels = _randint(gen, vpsde.n, batch.shape[0], batch)
        noise = _randn(gen, batch.shape, batch)
        perturbed = (_bcast(vpsde.sqrt_alphas_cumprod(batch)[labels], batch) * batch
                     + _bcast(vpsde.sqrt_1m_alphas_cumprod(batch)[labels], batch) * noise)
        score = model_apply(params, perturbed, labels, condition, mask, train=train,
                            generator=gen)
        losses = torch.square(score - noise)
        return reduce_op(losses.reshape(losses.shape[0], -1)).mean()

    return loss_fn


def mixed_precision_apply(model_apply: ModelApply, compute_dtype=torch.bfloat16) -> ModelApply:
    """Mixed precision for a model_apply, as the JAX package's: the f32
    params and the input cast explicitly to `compute_dtype` for the forward,
    the output cast back to f32. The time embedding, the condition and the
    mask stay f32, so a sum with them promotes the activations to f32 (as
    jnp promotes them) and the products after the first read bf16-rounded
    weights in f32. The casts are differentiable, so the gradients land on
    the f32 master weights and the loss, gradients and Adam moments stay
    f32."""

    def apply(p, x, labels, cond, msk, train=False, generator=None):
        p_c = tree_map(lambda a: a.to(compute_dtype) if a.dtype == torch.float32 else a, p)
        out = model_apply(p_c, x.to(compute_dtype), labels, cond, msk, train=train,
                          generator=generator)
        return out.float()

    return apply


def is_buffer(name: str) -> bool:
    """Leaves that never train, whatever the grad mask: the `sigmas` buffer
    and the fixed fourier projection `gauss_proj.W`."""
    parts = name.split(".")
    return "sigmas" in parts or ("gauss_proj" in parts and "W" in parts)


@dataclasses.dataclass
class TrainState:
    """The reference's mutable `state` dict. `opt_state` is the torch Adam
    over every leaf that is not a buffer; a step gives gradients to the
    trainable ones only."""

    step: int
    params: dict
    opt_state: torch.optim.Adam
    ema: ema_lib.EMAState

    def leaves(self) -> list[tuple[str, torch.Tensor]]:
        """(name, leaf) of the leaves the optimizer holds, in its order."""
        return [(n, p) for n, p in tree_to_flat(self.params).items() if not is_buffer(n)]


def init_train_state(params: dict, optimizer: Optimizer, ema_decay: float) -> TrainState:
    params = tree_map(lambda a: a.detach().clone(), params)
    state = TrainState(step=0, params=params, opt_state=None,
                       ema=ema_lib.init(params, decay=ema_decay))
    state.opt_state = optimizer.init([p for _, p in state.leaves()])
    return state


def get_step_fn(sde: SDE, model_apply: ModelApply, optimizer: Optional[Optimizer], train: bool,
                reduce_mean: bool = False, continuous: bool = True,
                likelihood_weighting: bool = False, grad_mask: Optional[dict] = None,
                sync=None):
    """step_fn(state, gen, batch, condition=None, mask=None) -> (state, loss).

    Train: loss and gradients of the trainable leaves, clip, Adam at the
    warmed-up lr, EMA update; the state is updated in place and returned.
    Eval: the loss under the EMA params. grad_mask: optional bool dict
    shaped like the params; False leaves stay frozen (the reference's
    requires_grad=False / ControlNet freeze()). The loss stays on the
    device. sync: the reductions of a step on a mesh (train.trainer's
    MeshSync): the draws of the global batch sliced to this rank
    (`sync.generator`), the gradients and the loss averaged over the mesh
    (`sync.reduce`) and the global gradient norm (`sync.grad_norm`)."""
    if continuous:
        loss_fn = get_sde_loss_fn(sde, model_apply, train, reduce_mean=reduce_mean,
                                  continuous=True, likelihood_weighting=likelihood_weighting)
    else:
        if likelihood_weighting:
            raise ValueError(
                "Likelihood weighting is not supported for original SMLD/DDPM training.")
        if isinstance(sde, VESDE):
            loss_fn = get_smld_loss_fn(sde, model_apply, train, reduce_mean=reduce_mean)
        elif isinstance(sde, VPSDE):
            loss_fn = get_ddpm_loss_fn(sde, model_apply, train, reduce_mean=reduce_mean)
        else:
            raise ValueError(f"Discrete training for {type(sde).__name__} is not recommended.")

    if not train:
        def eval_step(state: TrainState, gen, batch, condition=None, mask=None):
            with torch.no_grad():
                return state, loss_fn(ema_lib.params_of(state.ema), gen, batch, condition, mask)

        return eval_step

    flat_mask = tree_to_flat(grad_mask) if grad_mask is not None else None

    def step_fn(state: TrainState, gen, batch, condition=None, mask=None):
        names, trainable = zip(*[(n, p) for n, p in state.leaves()
                                 if flat_mask is None or flat_mask[n]])
        for p in trainable:
            p.requires_grad_(True)
        if sync is not None:
            gen = sync.generator(gen, batch)
        loss = loss_fn(state.params, gen, batch, condition, mask)
        # a leaf the forward does not read (the ControlNet's dense2_copy)
        # gets a zero gradient, as under jax.grad
        grads = [g if g is not None else torch.zeros_like(p) for p, g in
                 zip(trainable, torch.autograd.grad(loss, trainable, allow_unused=True))]
        grad_norm = None
        if sync is not None:
            grads, loss = sync.reduce(names, grads, loss)
            grad_norm = sync.grad_norm(names)
        for p, g in zip(trainable, grads):
            p.grad = g
        with torch.no_grad():
            optimizer.step(state.opt_state, list(trainable), state.step, grad_norm)
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        state.ema = ema_lib.update(state.ema, state.params)
        return state, loss.detach()

    return step_fn
