"""ControlNet-style infant adapter over ScoreMLP (port of
zedo_tpu/models/control_mlp.py; the reference's `Control_ScoreModelFC_Adv`).

Every trunk layer is duplicated as `*_copy`; zero-conv-like `zc_*` linear
bridges inject the control branch into the trunk; a learnable `infant_cond`
vector [j*d] seeds the control branch. `init_control_params` copies the
trunk weights into the copy branch; only the copy, zc and infant_cond leaves
are trainable (`trainable_mask`).

Kept from the checked-in reference: in each block's second control layer the
temb projection OVERWRITES the activation instead of adding to it
(`c = dense2_t_copy(temb)`). Released ZeDO-i checkpoints were trained with
this dataflow.

Inference only: `train=True` (dropout) waits for the training port
(ROADMAP.md Queue 1, item 13).
"""
from __future__ import annotations

from typing import Optional

import torch

from zedo_tpu_torch.models import nn
from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig, time_embedding
from zedo_tpu_torch.models.score_mlp import init_params as init_trunk_params
from zedo_tpu_torch.utils.config import resolve_device

Params = dict


def _copied_layers(cfg: ScoreMLPConfig) -> list[str]:
    names = ["pre_dense", "pre_dense_t", "pre_gnorm"]
    for idx in range(cfg.n_blocks):
        b = f"b{idx + 1}"
        names += [f"{b}_dense1", f"{b}_dense1_t", f"{b}_gnorm1",
                  f"{b}_dense2", f"{b}_dense2_t", f"{b}_gnorm2"]
    return names


def init_params(gen: torch.Generator, cfg: ScoreMLPConfig, dtype=torch.float32,
                device="cuda") -> Params:
    """Trunk params + zc bridges + infant_cond, drawn from `gen` on the CPU
    and moved to `device`; the `*_copy` branch is an exact trunk copy
    (`init_control_params`)."""
    dev = resolve_device(device)
    p = init_trunk_params(gen, cfg, dtype, dev)
    h, io = cfg.hidden_dim, cfg.n_joints * cfg.joint_dim
    p["infant_cond"] = torch.randn(io, generator=gen).to(device=dev, dtype=dtype)
    p["zc_layer_1"] = nn.init_linear(gen, io, io, dtype, dev)
    p["zc_layer_2"] = nn.init_linear(gen, h, h, dtype, dev)
    for idx in range(cfg.n_blocks):
        p[f"zc_b{idx + 1}_1"] = nn.init_linear(gen, h, h, dtype, dev)
        p[f"zc_b{idx + 1}_2"] = nn.init_linear(gen, h, h, dtype, dev)
    return init_control_params(p, cfg)


def init_control_params(params: Params, cfg: ScoreMLPConfig) -> Params:
    """Copy the trunk weights into the `_copy` branch."""
    p = dict(params)
    for name in _copied_layers(cfg):
        p[name + "_copy"] = {k: v.clone() for k, v in p[name].items()}
    return p


def trainable_mask(params: Params) -> dict:
    """True for the copy, zc and infant_cond leaves (the reference's
    freeze())."""

    def mark(key, value):
        if isinstance(value, dict):
            return {k: mark(key + "." + k, v) for k, v in value.items()}
        return "copy" in key or "zc" in key or key == "infant_cond"

    return {k: mark(k, v) for k, v in params.items()}


def apply(params: Params, cfg: ScoreMLPConfig, batch: torch.Tensor, t_labels: torch.Tensor,
          condition: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None, *,
          train: bool = False) -> torch.Tensor:
    """Forward at eval (dropout is the identity); condition and mask are
    accepted and ignored."""
    del condition, mask
    if train:
        raise NotImplementedError(
            "control_mlp.apply(train=True) waits for the training port (ROADMAP.md "
            "Queue 1, item 13)")
    bs = batch.shape[0]
    x = batch.reshape(bs, -1)
    g = cfg.group_norm_groups

    temb = time_embedding(params, cfg, t_labels)
    if cfg.embedding_type == "fourier":
        used_sigmas = t_labels
    else:
        used_sigmas = params["sigmas"][t_labels.long()]

    # control branch seed: batch + act(zc_1(infant_cond))
    c = x + nn.silu(nn.linear(params["zc_layer_1"], params["infant_cond"]))

    c = nn.linear(params["pre_dense_copy"], c)
    c = c + nn.linear(params["pre_dense_t_copy"], temb)
    c0 = nn.linear(params["zc_layer_2"], c)
    c = nn.silu(nn.group_norm(params["pre_gnorm_copy"], c, g))

    h = nn.linear(params["pre_dense"], x)
    h = h + nn.linear(params["pre_dense_t"], temb)
    h = h + c0
    h = nn.silu(nn.group_norm(params["pre_gnorm"], h, g))

    for idx in range(cfg.n_blocks):
        b = f"b{idx + 1}"
        orc = c
        c = nn.linear(params[f"{b}_dense1_copy"], c)
        c = c + nn.linear(params[f"{b}_dense1_t_copy"], temb)
        c1 = nn.linear(params[f"zc_{b}_1"], c)
        c = nn.silu(nn.group_norm(params[f"{b}_gnorm1_copy"], c, g))

        # the checked-in quirk: `c = dense2_t_copy(temb)`, `=` and not `+=`,
        # so the reference's dense2_copy(c) is discarded; it is not computed
        c = nn.linear(params[f"{b}_dense2_t_copy"], temb)
        c = c.expand(orc.shape)
        c2 = nn.linear(params[f"zc_{b}_2"], c)
        c = nn.silu(nn.group_norm(params[f"{b}_gnorm2_copy"], c, g))
        c = orc + c

        h1 = nn.linear(params[f"{b}_dense1"], h)
        h1 = h1 + nn.linear(params[f"{b}_dense1_t"], temb)
        h1 = h1 + c1
        h1 = nn.silu(nn.group_norm(params[f"{b}_gnorm1"], h1, g))

        h2 = nn.linear(params[f"{b}_dense2"], h1)
        h2 = h2 + nn.linear(params[f"{b}_dense2_t"], temb)
        h2 = h2 + c2
        h2 = nn.silu(nn.group_norm(params[f"{b}_gnorm2"], h2, g))

        h = h + h2

    res = nn.linear(params["post_dense"], h).reshape(bs, cfg.n_joints, -1)
    if cfg.scale_by_sigma:
        res = res / used_sigmas.reshape(bs, 1, 1)
    return res
