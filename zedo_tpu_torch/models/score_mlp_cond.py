"""Conditional score MLP (port of zedo_tpu/models/score_mlp_cond.py, the
reconstruction of the reference's missing `ScoreModelFC_Adv_cond`).

A 2D/3D condition is re-expressed as `batch - condition` with the z channel
masked for 2D conditions, embedded by a Linear+SiLU, and injected into every
dense layer through per-layer `*_cond` projections.

With train=True the re-expressed condition is masked at random
(`random_mask_condition`: whole pose, body part, joint) and every SiLU
output goes through dropout, all draws from the `generator` passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from zedo_tpu_torch.models import nn
from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig, time_embedding, used_sigmas
from zedo_tpu_torch.models.score_mlp import init_params as init_trunk
from zedo_tpu_torch.utils import rng
from zedo_tpu_torch.utils.config import resolve_device

Params = dict

# body parts: right leg, left leg, left arm, right arm, torso
PART_LIST = [[1, 2, 3], [4, 5, 6], [11, 12, 13], [14, 15, 16], [0, 7, 8, 9, 10]]


@dataclasses.dataclass(frozen=True)
class CondMaskConfig:
    """config.training.cond_*_mask_prob: train-time condition dropout."""

    pose_mask_prob: float = 0.0
    part_mask_prob: float = 0.0
    joint_mask_prob: float = 0.0


def init_params(gen: torch.Generator, cfg: ScoreMLPConfig, dtype=torch.float32,
                device="cuda") -> Params:
    """Trunk params + the condition embedding and per-layer projections,
    drawn from `gen` on the CPU and moved to `device`."""
    dev = resolve_device(device)
    p = init_trunk(gen, cfg, dtype, dev)
    h = cfg.hidden_dim
    io_cond = cfg.n_joints * cfg.joint_dim  # unified 3-channel condition
    p["cond_embed"] = {"0": nn.init_linear(gen, io_cond, h, dtype, dev)}
    p["pre_dense_cond"] = nn.init_linear(gen, h, h, dtype, dev)
    for idx in range(cfg.n_blocks):
        p[f"b{idx + 1}_dense1_cond"] = nn.init_linear(gen, h, h, dtype, dev)
        p[f"b{idx + 1}_dense2_cond"] = nn.init_linear(gen, h, h, dtype, dev)
    return p


def part_mask_table(n_joints: int) -> np.ndarray:
    """[p, j] masks, each zeroing one body part."""
    table = np.ones((len(PART_LIST), n_joints), dtype=np.float32)
    for idx, part in enumerate(PART_LIST):
        table[idx, [j for j in part if j < n_joints]] = 0
    return table


def random_mask_condition(generator: torch.Generator, condition: torch.Tensor,
                          cfg: ScoreMLPConfig, mask_cfg: CondMaskConfig) -> torch.Tensor:
    """Train-time condition dropout: whole-pose, body-part and per-joint
    Bernoulli masking of condition [B, j, c], each draw from `generator`
    (in that order, each only when its probability is positive)."""
    b, dev = condition.shape[0], condition.device

    def bernoulli(p, shape):
        return rng.rand(generator, shape, device=dev) < p

    if mask_cfg.pose_mask_prob > 0:
        drop = bernoulli(mask_cfg.pose_mask_prob, (b, 1, 1))
        condition = condition * (1.0 - drop.to(condition.dtype))
    if mask_cfg.part_mask_prob > 0:
        table = torch.as_tensor(part_mask_table(cfg.n_joints), device=dev)  # [p, j]
        sel = bernoulli(mask_cfg.part_mask_prob, (b, table.shape[0]))
        # product over the selected parts' masks; all ones when none is selected
        masks = torch.where(sel[..., None], table[None], torch.ones_like(table)[None])
        condition = condition * masks.prod(dim=1)[..., None].to(condition.dtype)
    if mask_cfg.joint_mask_prob > 0:
        drop = bernoulli(mask_cfg.joint_mask_prob, (b, cfg.n_joints, 1))
        condition = condition * (1.0 - drop.to(condition.dtype))
    return condition


def apply(params: Params, cfg: ScoreMLPConfig, batch: torch.Tensor, t_labels: torch.Tensor,
          condition: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None, *,
          mask_cfg: CondMaskConfig = CondMaskConfig(), train: bool = False,
          generator: Optional[torch.Generator] = None,
          force_null_condition: bool = False) -> torch.Tensor:
    """Forward with condition injection.

    condition: [B, j, 2|3] keypoints (2D padded with a zero z channel),
    re-expressed as batch - condition with z masked out when the condition
    carries no depth. mask: eval-time condition mask [B, j, c] (ignored in
    training). force_null_condition: zero the RE-EXPRESSED condition, the
    null state of train-time condition dropout. condition=None means that
    null state too; raw zero keypoints would re-express to cond = batch.xy,
    a strong fake condition. train: `random_mask_condition` with `mask_cfg`,
    then dropout after each SiLU, all draws from `generator`."""
    bs = batch.shape[0]
    g = cfg.group_norm_groups

    if condition is None:
        condition = torch.zeros_like(batch)
        force_null_condition = True
    if condition.shape[-1] == 2:
        condition = torch.cat([condition, torch.zeros_like(condition[..., :1])], dim=-1)
    # unified 2D/3D: a nonzero z channel anywhere makes a 3D condition
    z_mask = condition[:, :, -1].abs().sum(-1, keepdim=True) > 0
    cond = batch - condition
    cond = torch.cat([cond[..., :-1], cond[..., -1:] * z_mask[..., None].to(cond.dtype)], -1)
    if force_null_condition:
        cond = torch.zeros_like(cond)
    if not train and mask is not None:
        cond = cond * mask
    if train:
        cond = random_mask_condition(generator, cond, cfg, mask_cfg)

    def drop(v):
        return nn.dropout(v, cfg.dropout, train, generator)

    cond_h = nn.silu(nn.linear(params["cond_embed"]["0"], cond.reshape(bs, -1)))

    temb = time_embedding(params, cfg, t_labels)

    x = batch.reshape(bs, -1)
    h = nn.linear(params["pre_dense"], x)
    h = h + nn.linear(params["pre_dense_t"], temb)
    h = h + nn.linear(params["pre_dense_cond"], cond_h)
    h = drop(nn.silu(nn.group_norm(params["pre_gnorm"], h, g)))

    for idx in range(cfg.n_blocks):
        b = f"b{idx + 1}"
        h1 = nn.linear(params[f"{b}_dense1"], h)
        h1 = h1 + nn.linear(params[f"{b}_dense1_t"], temb)
        h1 = h1 + nn.linear(params[f"{b}_dense1_cond"], cond_h)
        h1 = drop(nn.silu(nn.group_norm(params[f"{b}_gnorm1"], h1, g)))

        h2 = nn.linear(params[f"{b}_dense2"], h1)
        h2 = h2 + nn.linear(params[f"{b}_dense2_t"], temb)
        h2 = h2 + nn.linear(params[f"{b}_dense2_cond"], cond_h)
        h2 = drop(nn.silu(nn.group_norm(params[f"{b}_gnorm2"], h2, g)))

        h = h + h2

    res = nn.linear(params["post_dense"], h).reshape(bs, cfg.n_joints, -1)
    if cfg.scale_by_sigma:
        res = res / used_sigmas(params, cfg, t_labels).reshape(bs, 1, 1)
    return res


def classifier_free_apply(params, cfg, batch, t_labels, condition, w: float,
                          **kwargs) -> torch.Tensor:
    """Classifier-free guidance: out + w * (out - out_uncond), the
    unconditional output at the train-time dropout null."""
    out = apply(params, cfg, batch, t_labels, condition, **kwargs)
    out_uncond = apply(params, cfg, batch, t_labels, condition,
                       force_null_condition=True, **kwargs)
    return out + w * (out - out_uncond)
