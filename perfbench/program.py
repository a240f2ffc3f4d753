"""The system under test, zedo_tpu_torch, built from a configuration file:
its model config, SDE, sampler and ZeDO block as its CLIs build them
(`presets.from_optim_config`), from the keys of perfbench/configs/."""
from __future__ import annotations

import torch

from perfbench import weights


def model_config(cfg: dict):
    from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig

    m = cfg["model"]
    return ScoreMLPConfig(
        n_joints=m["n_joints"], joint_dim=m["joint_dim"], hidden_dim=m["hidden_dim"],
        embed_dim=m["embed_dim"], n_blocks=m["n_blocks"], embedding_type=m["embedding_type"],
        scale_by_sigma=m["scale_by_sigma"], dropout=m["dropout"], sigma_min=m["sigma_min"],
        sigma_max=m["sigma_max"], num_scales=m["num_scales"],
        group_norm_groups=m["group_norm_groups"])


def solver(cfg: dict, schedule: dict = None):
    """(model config, SDE, sampler, ZeDOConfig) of the solve; `schedule`
    re-discretizes it as ZeDOEstimator.with_schedule does."""
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.zeroshot.ipo import IPOConfig
    from zedo_tpu_torch.zeroshot.oil import OILConfig
    from zedo_tpu_torch.zeroshot.pipeline import ZeDOConfig

    z = {**cfg["zedo"], **(schedule or {})}
    sde = SubVPSDE(beta_min=cfg["sde"]["beta_min"], beta_max=cfg["sde"]["beta_max"],
                   n=z["OIL_iterations"], t_max=cfg["sde"]["T"])
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=z["sampling_eps"])
    zcfg = ZeDOConfig(
        ipo=IPOConfig(iterations=z["IPO_iterations"], keypoint_list=tuple(z["IPO_keylist"]),
                      rot_axes=z["RotAxes"], t_norm=z["IPO_T"], min_scale_t=z["IPO_minScaleT"],
                      max_scale_t=z["IPO_maxScaleT"], lr=z["IPO_lr"]),
        oil=OILConfig(iterations=z["OIL_iterations"], sampling_eps=z["sampling_eps"],
                      score_reuse=z["score_reuse"], gn_fp32=z["gn_fp32"],
                      track_reproj=cfg["pipeline"]["track_reproj"]))
    return model_config(cfg), sde, sampler, zcfg


def dtype_of(name: str):
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


def params(seed: int, cfg: dict, device, dtype: str) -> dict:
    """The program's nested weights from the seed, in `dtype`."""
    return weights.nested(weights.make(seed, cfg["model"], device, dtype_of(dtype)))


def reference_params(seed: int, cfg: dict, device, dtype: str) -> dict:
    """The same values as f32 leaves by name, for the reference."""
    return {k: v.float() for k, v in weights.make(seed, cfg["model"], device,
                                                  dtype_of(dtype)).items()}


def free(device) -> None:
    """Drop the program's compiled programs and return cached blocks, so
    that the reference runs on what the program has let go."""
    import gc

    from zedo_tpu_torch.utils import compiled

    compiled.clear_cache()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
