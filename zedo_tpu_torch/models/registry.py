"""Score-model configuration from a nested config (port of `make_mlp_config`
from zedo_tpu/models/registry.py; `register_model` and `create_model` wait
for the training port, ROADMAP.md Queue 1, item 13)."""
from __future__ import annotations

from zedo_tpu_torch.models import score_mlp


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
