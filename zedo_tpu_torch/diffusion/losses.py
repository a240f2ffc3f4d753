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
import functools
from typing import Callable, Optional

import numpy as np
import torch

from zedo_tpu_torch.diffusion import ema as ema_lib
from zedo_tpu_torch.diffusion.score import get_score_fn
from zedo_tpu_torch.diffusion.sde import SDE, VESDE, VPSDE, _bcast, _randn
from zedo_tpu_torch.models.nn import tree_map, tree_to_flat
from zedo_tpu_torch.utils import compiled as compiled_lib
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
    scheduled learning rate (`table`, lr_schedule's values) and steps."""

    grad_clip: float
    weight_decay: float
    beta1: float
    eps: float
    lr: float
    warmup: int

    def table(self) -> np.ndarray:
        """[warmup + 1] f32: the learning rate of steps 0..warmup as JAX's
        schedule computes it on the device (f32(step) / f32(warmup), capped
        at 1, times f32(lr)); every later step reads the last entry."""
        if self.warmup <= 0:
            return np.array([self.lr], np.float32)
        steps = np.arange(self.warmup + 1, dtype=np.float32)
        return np.float32(self.lr) * np.minimum(steps / np.float32(self.warmup),
                                                np.float32(1.0))

    def init(self, leaves: list) -> torch.optim.Adam:
        """On the card fused and capturable, the learning rate a device
        tensor (written by each step); on the CPU a Python float."""
        lr = float(self.table()[0])
        kw = dict(betas=(self.beta1, 0.999), eps=self.eps, weight_decay=self.weight_decay)
        if bool(leaves) and leaves[0].device.type == "cuda":
            return torch.optim.Adam(leaves, lr=torch.tensor(lr, device=leaves[0].device),
                                    fused=True, capturable=True, **kw)
        return torch.optim.Adam(leaves, lr=lr, **kw)

    def ensure_state(self, adam: torch.optim.Adam, trainable: list) -> None:
        """The moments and step count of each trainable leaf, as Adam makes
        them at its first step, made before the first step: the compiled
        step's buffers exist before its capture."""
        group = adam.param_groups[0]
        on_device = group["capturable"] or group["fused"]
        for p in trainable:
            if p in adam.state and adam.state[p]:
                continue
            adam.state[p] = {
                "step": (torch.zeros((), dtype=torch.float32, device=p.device) if on_device
                         else torch.tensor(0.0, dtype=torch.float32)),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def load_state(self, adam: torch.optim.Adam, state_dict: dict) -> None:
        """adam.load_state_dict, keeping the groups' device settings (a
        checkpoint's are those of the device that wrote it) and each step
        count where they put it."""
        kept = [{k: g[k] for k in ("lr", "capturable", "fused", "foreach")}
                for g in adam.param_groups]
        adam.load_state_dict(state_dict)
        for group, settings in zip(adam.param_groups, kept):
            group.update(settings)
            on_device = settings["capturable"] or settings["fused"]
            for p in group["params"]:
                st = adam.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(device=p.device if on_device else "cpu",
                                               dtype=torch.float32)

    def step(self, adam: torch.optim.Adam, trainable: list, lr_table: torch.Tensor,
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """grad_norm: the global norm of the leaves' gradients where it is not
        their own (tensor-parallel shards), clipped as clip_grad_norm_ does.
        The learning rate is lr_table's entry at Adam's step count before
        this step (optax's count)."""
        if self.grad_clip >= 0:
            if grad_norm is None:
                torch.nn.utils.clip_grad_norm_(trainable, self.grad_clip)
            else:
                grads = [p.grad for p in trainable]
                coef = torch.clamp(self.grad_clip / (grad_norm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, coef)
        count = adam.state[trainable[0]]["step"].to(lr_table.device)
        index = count.clamp(max=lr_table.shape[0] - 1).long().reshape(1)
        lr = lr_table.index_select(0, index).reshape(())
        for group in adam.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].copy_(lr)
            else:
                group["lr"] = float(lr)  # the CPU's Adam takes a Python float
        adam.step()


@functools.lru_cache(maxsize=None)
def _lr_table(optimizer: Optimizer, device: str) -> torch.Tensor:
    return torch.from_numpy(optimizer.table()).to(device)


def get_optimizer(config) -> Optimizer:
    if config.optim.optimizer != "Adam":
        raise NotImplementedError(f"Optimizer {config.optim.optimizer} not supported yet!")
    return Optimizer(grad_clip=float(config.optim.grad_clip),
                     weight_decay=float(config.optim.get("weight_decay", 0) or 0),
                     beta1=float(config.optim.beta1), eps=float(config.optim.eps),
                     lr=float(config.optim.lr), warmup=int(config.optim.warmup))


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


def _train_carry(state: TrainState, trainable: list, optimizer: Optimizer) -> dict:
    """The train state's tensors, the compiled step's donated buffers: the
    params, the trainable leaves' Adam moments and step counts, the
    learning rate (a tensor on the card), its table, the EMA's shadows and
    count; the Adam and the EMA's decay ride along as static values."""
    adam = state.opt_state
    lr = adam.param_groups[0]["lr"]
    return {"params": state.params, "adam": adam,
            "moments": [adam.state[p] for p in trainable],
            "lr": lr if torch.is_tensor(lr) else None,
            "lr_table": _lr_table(optimizer, str(trainable[0].device)),
            "ema": {"decay": state.ema.decay, "count": state.ema.num_updates,
                    "shadow": state.ema.shadow_params}}


def _train_body(carry, consts, ys, counter, generator, variant, *, loss_fn, names: tuple,
                optimizer: Optimizer, sync, stage: str):
    """One train step on the state's tensors (utils/compiled.py's contract).
    stage "whole": loss, gradients, clip, Adam, EMA; on a mesh the step runs
    as "grads" (the loss and this rank's gradients into ys) and "update"
    (the clip, Adam and EMA from the mesh's reduced gradients in consts),
    with the collectives between them, outside the graphs."""
    params, adam = carry["params"], carry["adam"]
    flat = tree_to_flat(params)
    trainable = [flat[n] for n in names]
    grad_norm = None
    if stage == "update":
        grads, grad_norm = consts["grads"], consts["grad_norm"]
    else:
        batch = consts["batch"]
        for p in trainable:
            p.requires_grad_(True)
        gen = generator if sync is None else sync.generator(generator, batch)
        loss = loss_fn(params, gen, batch, consts["condition"], consts["mask"])
        # a leaf the forward does not read (the ControlNet's dense2_copy)
        # gets a zero gradient, as under jax.grad
        grads = [g if g is not None else torch.zeros_like(p) for p, g in
                 zip(trainable, torch.autograd.grad(loss, trainable, allow_unused=True))]
        ys["loss"].copy_(loss.detach().reshape(1))
        if stage == "grads":
            for out, g in zip(ys["grads"], grads):
                out.copy_(g)
            return carry
    for p, g in zip(trainable, grads):
        p.grad = g
    with torch.no_grad():
        optimizer.step(adam, trainable, carry["lr_table"], grad_norm)
    adam.zero_grad(set_to_none=True)
    ema = carry["ema"]
    ema_lib.update_(ema_lib.EMAState(ema["decay"], ema["count"], ema["shadow"]), params)
    return carry


def get_step_fn(sde: SDE, model_apply: ModelApply, optimizer: Optional[Optimizer], train: bool,
                reduce_mean: bool = False, continuous: bool = True,
                likelihood_weighting: bool = False, grad_mask: Optional[dict] = None,
                sync=None, compiled: bool = False):
    """step_fn(state, gen, batch, condition=None, mask=None) -> (state, loss).

    Train: loss and gradients of the trainable leaves, clip, Adam at the
    warmed-up lr, EMA update; the state is updated in place and returned.
    Eval: the loss under the EMA params. grad_mask: optional bool dict
    shaped like the params; False leaves stay frozen (the reference's
    requires_grad=False / ControlNet freeze()). The loss stays on the
    device. sync: the reductions of a step on a mesh (train.trainer's
    MeshSync): the draws of the global batch sliced to this rank
    (`sync.generator`), the gradients and the loss averaged over the mesh
    (`sync.reduce`) and the global gradient norm (`sync.grad_norm`);
    `sync.forward_collectives`: the model's forward and backward run
    collectives themselves (tensor parallelism). compiled: the train step
    as compiled calls (CUDA graphs on the card, replayed on the state's
    tensors; see the module docstring), else the same body eagerly."""
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
        optimizer.ensure_state(state.opt_state, list(trainable))
        carry = _train_carry(state, list(trainable), optimizer)
        consts = {"batch": batch, "condition": condition, "mask": mask}
        program = functools.partial(_train_body, loss_fn=loss_fn, names=tuple(names),
                                    optimizer=optimizer, sync=sync)
        ys = {"loss": torch.zeros(1, dtype=torch.float32, device=batch.device)}
        if sync is None:
            _, ys = compiled_lib.step(functools.partial(program, stage="whole"), carry, consts,
                                      ys, gen, compiled=compiled, donate=True)
            loss = ys["loss"][0]
        else:
            ys["grads"] = [torch.zeros_like(p) for p in trainable]
            # a forward that runs collectives between its layers (tensor
            # parallelism) cannot be captured: its gradients run eagerly
            _, ys = compiled_lib.step(functools.partial(program, stage="grads"), carry, consts,
                                      ys, gen, compiled=compiled and not sync.forward_collectives,
                                      donate=True)
            grads, loss = sync.reduce(names, ys["grads"], ys["loss"][0])
            norm = sync.grad_norm(names)
            compiled_lib.step(functools.partial(program, stage="update"), carry,
                              {"grads": list(grads),
                               "grad_norm": None if norm is None else norm(grads)},
                              compiled=compiled, donate=True)
        state.step += 1
        return state, loss

    return step_fn
