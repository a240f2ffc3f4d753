"""Serving configurations as plain dataclasses.

The shared `configs/optim/*.py` files build ml_collections configs; the port
does not depend on ml_collections, so the configuration that serving needs
is restated here. `h36m()` holds the values of
configs/optim/concat_pose_optimization_h36m.py (through configs/optim/_base.py
and configs/default_pose_gen_configs.py) as the JAX package's serving path
resolves them; a test holds the two against each other.
"""
from __future__ import annotations

import dataclasses

from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig
from zedo_tpu_torch.zeroshot.ipo import IPOConfig
from zedo_tpu_torch.zeroshot.oil import OILConfig
from zedo_tpu_torch.zeroshot.pipeline import ZeDOConfig


@dataclasses.dataclass(frozen=True)
class Preset:
    model_cfg: ScoreMLPConfig
    sde: SubVPSDE
    sampler: PCSampler
    zcfg: ZeDOConfig


def h36m(**model_dims) -> Preset:
    """The H36M serving configuration. `model_dims` overrides ScoreMLPConfig
    widths (hidden_dim, embed_dim, n_blocks) for checkpoints of another size;
    the published model is the default 1024/512/2."""
    model_cfg = ScoreMLPConfig(embedding_type="positional", fourier_scale=16.0,
                               scale_by_sigma=False, dropout=0.1, sigma_min=0.01, sigma_max=50.0,
                               num_scales=1000, **model_dims)
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
    # serving forces the probability flow (deterministic step)
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        snr=0.16, n_steps=1, probability_flow=True,
                        continuous=True, denoise=True, eps=0.01)
    zcfg = ZeDOConfig(
        ipo=IPOConfig(iterations=500, keypoint_list=(0, 1, 4), rot_axes="z",
                      t_norm=3.0, min_scale_t=0.5, max_scale_t=2.0),
        oil=OILConfig(iterations=1000, sampling_eps=0.01),
    )
    return Preset(model_cfg=model_cfg, sde=sde, sampler=sampler, zcfg=zcfg)
