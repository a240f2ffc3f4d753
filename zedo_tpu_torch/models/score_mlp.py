"""ScoreMLP: the pose-prior denoiser (reference `ScoreModelFC_Adv`).

Port of zedo_tpu/models/score_mlp.py: a residual MLP over flattened poses
[B, j*d] with time-conditioned blocks, as a pure function of a params dict
whose keys mirror the torch state_dict, plus a static `ScoreMLPConfig`.

    h  = pre_dense(x) + pre_dense_t(temb); GN(32); SiLU
    2 x residual block:
        h1 = act(GN(dense1(h)  + dense1_t(temb)))
        h2 = act(GN(dense2(h1) + dense2_t(temb)))
        h  = h + h2
    out = post_dense(h) -> [B, j, d]

With train=True every SiLU output goes through dropout (cfg.dropout), its
masks drawn from the `generator` passed in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from zedo_tpu_torch.models import nn
from zedo_tpu_torch.utils.config import resolve_device

Params = dict


@dataclasses.dataclass(frozen=True)
class ScoreMLPConfig:
    n_joints: int = 17
    joint_dim: int = 3
    hidden_dim: int = 1024
    embed_dim: int = 512
    cond_dim: int = 3  # accepted for API parity; conditioning is dead in ref
    n_blocks: int = 2
    embedding_type: str = "positional"  # 'fourier' | 'positional'
    fourier_scale: float = 16.0
    scale_by_sigma: bool = False
    dropout: float = 0.25
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 1000
    group_norm_groups: int = 32

    def __post_init__(self):
        # size-1 groups normalize every activation to its bias, making the
        # network constant in its input
        if self.hidden_dim < 2 * self.group_norm_groups:
            raise ValueError(
                f"hidden_dim={self.hidden_dim} with group_norm_groups="
                f"{self.group_norm_groups} gives GroupNorm groups of "
                f"{self.hidden_dim // self.group_norm_groups} channel(s); "
                f"size-1 groups normalize every activation to its bias, "
                f"making the network constant in its input — widen "
                f"hidden_dim or lower group_norm_groups")
        if self.hidden_dim % self.group_norm_groups:
            raise ValueError(
                f"hidden_dim={self.hidden_dim} not divisible by "
                f"group_norm_groups={self.group_norm_groups}")


def get_sigmas(cfg: ScoreMLPConfig) -> np.ndarray:
    """Geometric sigma ladder (model.py:68-78)."""
    return np.exp(np.linspace(math.log(cfg.sigma_max), math.log(cfg.sigma_min),
                              cfg.num_scales))


def gaussian_fourier_projection(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Random-feature time encoding: x [B] -> [B, 2*|w|]."""
    x_proj = x[:, None] * w[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal positional embedding of continuous timesteps [B]."""
    if timesteps.dim() != 1:
        raise ValueError(f"timesteps must be [B], got {tuple(timesteps.shape)}")
    half_dim = embedding_dim // 2
    scale = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -scale)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def init_params(gen: torch.Generator, cfg: ScoreMLPConfig, dtype=torch.float32,
                device="cuda") -> Params:
    """Random params (torch default init) drawn from `gen` on the CPU and
    moved to `device`; keys mirror the torch state_dict names."""
    dev = resolve_device(device)
    h, e, io = cfg.hidden_dim, cfg.embed_dim, cfg.n_joints * cfg.joint_dim

    def lin(i, o):
        return nn.init_linear(gen, i, o, dtype, dev)

    p: Params = {
        "pre_dense": lin(io, h),
        "pre_dense_t": lin(e, h),
        "pre_gnorm": nn.init_group_norm(h, dtype, dev),
        "shared_time_embed": {"0": lin(e, e)},
        "post_dense": lin(h, io),
        "sigmas": torch.as_tensor(get_sigmas(cfg), dtype=dtype, device=dev),
    }
    if cfg.embedding_type == "fourier":
        w = torch.randn(e // 2, generator=gen) * cfg.fourier_scale
        p["gauss_proj"] = {"W": w.to(device=dev, dtype=dtype)}
    for idx in range(cfg.n_blocks):
        b = f"b{idx + 1}"
        p[f"{b}_dense1"] = lin(h, h)
        p[f"{b}_dense1_t"] = lin(e, h)
        p[f"{b}_gnorm1"] = nn.init_group_norm(h, dtype, dev)
        p[f"{b}_dense2"] = lin(h, h)
        p[f"{b}_dense2_t"] = lin(e, h)
        p[f"{b}_gnorm2"] = nn.init_group_norm(h, dtype, dev)
    return p


def time_embedding(params: Params, cfg: ScoreMLPConfig,
                   t_labels: torch.Tensor) -> torch.Tensor:
    """Shared time embedding [B] -> [B, embed_dim]; t_labels are the
    model-facing labels (t*999 for continuous sub-VP)."""
    if cfg.embedding_type == "fourier":
        temb = gaussian_fourier_projection(params["gauss_proj"]["W"], torch.log(t_labels))
    elif cfg.embedding_type == "positional":
        temb = get_timestep_embedding(t_labels, cfg.embed_dim)
    else:
        raise ValueError(f"time embedding type {cfg.embedding_type} unknown.")
    return nn.silu(nn.linear(params["shared_time_embed"]["0"], temb))


def _identity(h: torch.Tensor) -> torch.Tensor:
    return h


def _add_bias(product: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return product + bias


def apply_with_temb(params: Params, cfg: ScoreMLPConfig, batch: torch.Tensor,
                    temb: torch.Tensor, *, used_sigmas: Optional[torch.Tensor] = None,
                    train: bool = False, generator: Optional[torch.Generator] = None,
                    intermediates: Optional[dict] = None,
                    gather: Callable = _identity, reduce: Callable = _add_bias) -> torch.Tensor:
    """Trunk forward given a precomputed shared time embedding.

    batch: [B, j, d]; temb: [B, embed] or [embed] (broadcast over batch).
    train: dropout after each SiLU, masks from `generator`.
    intermediates: optional dict filled with named per-layer activations.
    gather, reduce: the hooks of a model whose hidden channels are sharded
    (parallel.tensor_parallel): `gather(h)` gives a residual layer its whole
    input from this rank's channels, `reduce(product, bias)` post_dense's
    output from this rank's partial product. GroupNorm takes the channels it
    is given in groups of hidden_dim / group_norm_groups."""
    bs = batch.shape[0]
    x = batch.reshape(bs, -1)
    if temb.dim() == 1:
        temb = temb.expand(bs, temb.shape[0])

    def drop(v):
        return nn.dropout(v, cfg.dropout, train, generator)

    def rec(name, v):
        if intermediates is not None:
            intermediates[name] = v

    g = params["pre_gnorm"]["weight"].shape[0] * cfg.group_norm_groups // cfg.hidden_dim
    h = nn.linear(params["pre_dense"], x)
    h = h + nn.linear(params["pre_dense_t"], temb)
    h = nn.group_norm(params["pre_gnorm"], h, g)
    rec("pre_gnorm", h)
    h = drop(nn.silu(h))

    for idx in range(cfg.n_blocks):
        b = f"b{idx + 1}"
        h1 = nn.linear(params[f"{b}_dense1"], gather(h))
        h1 = h1 + nn.linear(params[f"{b}_dense1_t"], temb)
        h1 = nn.group_norm(params[f"{b}_gnorm1"], h1, g)
        rec(f"{b}_gnorm1", h1)
        h1 = drop(nn.silu(h1))

        h2 = nn.linear(params[f"{b}_dense2"], gather(h1))
        h2 = h2 + nn.linear(params[f"{b}_dense2_t"], temb)
        h2 = nn.group_norm(params[f"{b}_gnorm2"], h2, g)
        rec(f"{b}_gnorm2", h2)
        h2 = drop(nn.silu(h2))

        h = h + h2

    post = params["post_dense"]
    dt = torch.promote_types(h.dtype, post["weight"].dtype)
    res = reduce(h.to(dt) @ post["weight"].to(dt).T, post["bias"].to(dt))
    res = res.reshape(bs, cfg.n_joints, -1)
    if cfg.scale_by_sigma:
        res = res / used_sigmas.reshape(bs, 1, 1)
    return res


def used_sigmas(params: Params, cfg: ScoreMLPConfig, t_labels: torch.Tensor):
    """The sigmas a `scale_by_sigma` model divides by (None otherwise): the
    labels themselves for fourier, else the sigma ladder at the labels,
    indices clamped into it as a JAX gather clamps them."""
    if not cfg.scale_by_sigma:
        return None
    if cfg.embedding_type == "fourier":
        return t_labels
    sigmas = params["sigmas"]
    return sigmas[t_labels.long().clamp(0, len(sigmas) - 1)]


def apply(params: Params, cfg: ScoreMLPConfig, batch: torch.Tensor,
          t_labels: torch.Tensor, condition=None, mask=None, *, train: bool = False,
          generator: Optional[torch.Generator] = None,
          intermediates: Optional[dict] = None, gather: Callable = _identity,
          reduce: Callable = _add_bias) -> torch.Tensor:
    """Full forward; condition/mask are accepted and ignored, as in the
    reference's unconditional model. gather, reduce: apply_with_temb's
    tensor-parallel hooks."""
    del condition, mask
    temb = time_embedding(params, cfg, t_labels)
    if intermediates is not None:
        intermediates["temb"] = temb
    return apply_with_temb(params, cfg, batch, temb,
                           used_sigmas=used_sigmas(params, cfg, t_labels), train=train,
                           generator=generator, intermediates=intermediates,
                           gather=gather, reduce=reduce)
