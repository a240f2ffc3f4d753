"""Model registry (port of zedo_tpu/models/registry.py, the reference's
register_model / get_model / create_model): a registered model is an
(init_params, apply, make_config) triple keyed by name, and `create_model`
builds its params and apply from a nested config."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from zedo_tpu_torch.models import control_mlp, score_mlp, score_mlp_cond

_MODELS: dict[str, "ModelDef"] = {}


class ModelDef(NamedTuple):
    init_params: Callable  # (generator, cfg, dtype=, device=) -> params
    apply: Callable
    make_config: Callable  # (config, **dims) -> ScoreMLPConfig


def register_model(model: ModelDef = None, *, name: str = None):
    def _register(model):
        if name in _MODELS:
            raise ValueError(f"Already registered model with name: {name}")
        _MODELS[name] = model
        return model

    return _register(model) if model is not None else _register


def get_model(name: str) -> ModelDef:
    return _MODELS[name]


def make_mlp_config(config, n_joints=17, joint_dim=3, hidden_dim=1024,
                    embed_dim=512, cond_dim=3, n_blocks=2) -> score_mlp.ScoreMLPConfig:
    """Dims from the CLI's constants, the rest from config.model.

    `config.model.hidden_dim` / `embed_dim` / `n_blocks`, when present,
    override the caller's dims, so a checkpoint of another width (the
    committed 256-wide trained fixture) runs through the CLI by override."""
    model = config.model
    return score_mlp.ScoreMLPConfig(
        n_joints=n_joints,
        joint_dim=joint_dim,
        hidden_dim=int(model.get("hidden_dim", hidden_dim)),
        embed_dim=int(model.get("embed_dim", embed_dim)),
        cond_dim=cond_dim,
        n_blocks=int(model.get("n_blocks", n_blocks)),
        embedding_type=model.embedding_type.lower(),
        fourier_scale=float(model.get("fourier_scale", 16.0)),
        scale_by_sigma=bool(model.scale_by_sigma),
        dropout=float(model.get("dropout", 0.25)),
        sigma_min=float(model.sigma_min),
        sigma_max=float(model.sigma_max),
        num_scales=int(model.num_scales),
    )


register_model(ModelDef(score_mlp.init_params, score_mlp.apply, make_mlp_config),
               name="score_mlp")
# the reference registers its MLP under the legacy name 'ncsnpp' (the configs'
# model.name)
register_model(ModelDef(score_mlp.init_params, score_mlp.apply, make_mlp_config),
               name="ncsnpp")
register_model(ModelDef(control_mlp.init_params, control_mlp.apply, make_mlp_config),
               name="control_mlp")
register_model(ModelDef(score_mlp_cond.init_params, score_mlp_cond.apply, make_mlp_config),
               name="score_mlp_cond")


def create_model(config, name: str = None, generator: torch.Generator = None,
                 device="cuda", **dims):
    """(params, apply, model_cfg) from a nested config; the params drawn
    from `generator` (default seeded 0) and placed on `device`."""
    model = get_model(name or config.model.name)
    cfg = model.make_config(config, **dims)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return model.init_params(gen, cfg, device=device), model.apply, cfg
