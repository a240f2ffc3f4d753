"""The ZeDO zero-shot pipeline: cluster init -> IPO -> OIL, for S hypotheses.

Port of zedo_tpu/zeroshot/pipeline.py. The JAX package vmaps one
hypothesis's program over S; here the S hypotheses are folded into the
batch (rows ordered hypothesis-major, s*N + n), so IPO and OIL run once on
S*N rows and the score network sees all of them in one launch per step.
IPO keeps each hypothesis's own mean loss (zeroshot/ipo.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.zeroshot.ipo import IPOConfig, run_ipo
from zedo_tpu_torch.zeroshot.oil import OILConfig, OILResult, run_oil


@dataclasses.dataclass(frozen=True)
class ZeDOConfig:
    """Static pipeline configuration (the config.ZeDO block)."""

    ipo: IPOConfig = IPOConfig()
    oil: OILConfig = OILConfig()


class SolveResult(NamedTuple):
    poses: torch.Tensor  # [N, S, j, 3]
    translations: torch.Tensor  # [N, S, 1, 3]


def _solve_folded(params, model_cfg, sde, sampler, cfg: ZeDOConfig,
                  cluster_poses, cond2d, conf, k, model_apply=None) -> OILResult:
    """All hypotheses in one batch of S*N rows, hypothesis-major."""
    cluster_poses = torch.as_tensor(cluster_poses, dtype=cond2d.dtype,
                                    device=cond2d.device)
    s, n = cluster_poses.shape[0], cond2d.shape[0]
    # root-center each cluster pose and broadcast it over the batch
    pose0 = cluster_poses - cluster_poses[:, 0:1, :]
    pose0 = pose0[:, None].expand(s, n, *pose0.shape[1:]).reshape(s * n, *pose0.shape[1:])
    cond2d = cond2d.repeat(s, 1, 1)
    k = k.repeat(s, 1, 1)
    conf = None if conf is None else conf.repeat(s, 1)

    ipo = run_ipo(pose0, cond2d, k, cfg.ipo, n_groups=s)
    x0 = torch.einsum("bij,bnj->bni", ipo.rot_mat, pose0)
    return run_oil(params, model_cfg, sde, sampler, x0, ipo.translation,
                   cond2d, k, conf, cfg.oil, model_apply=model_apply)


def solve_one_hypothesis(params: dict, model_cfg: score_mlp.ScoreMLPConfig,
                         sde: SDE, sampler: PCSampler, cfg: ZeDOConfig,
                         cluster_pose: torch.Tensor, cond2d: torch.Tensor,
                         conf: Optional[torch.Tensor], k: torch.Tensor,
                         model_apply=None) -> OILResult:
    """One hypothesis [j, 3] over the full batch: OILResult of [N, ...]."""
    return _solve_folded(params, model_cfg, sde, sampler, cfg,
                         torch.as_tensor(cluster_pose)[None], cond2d, conf, k,
                         model_apply)


def solve(params: dict, model_cfg: score_mlp.ScoreMLPConfig, sde: SDE,
          sampler: PCSampler, cfg: ZeDOConfig, cluster_poses: torch.Tensor,
          cond2d: torch.Tensor, conf: Optional[torch.Tensor], k: torch.Tensor,
          model_apply=None) -> SolveResult:
    """All S hypotheses [S, j, 3] over cond2d [N, j, >=2], k [N, 3, 3];
    returns [N, S, j, 3] poses and [N, S, 1, 3] translations."""
    s, n = len(cluster_poses), cond2d.shape[0]
    res = _solve_folded(params, model_cfg, sde, sampler, cfg, cluster_poses,
                        cond2d, conf, k, model_apply)
    return SolveResult(
        poses=res.pose.reshape(s, n, *res.pose.shape[1:]).transpose(0, 1),
        translations=res.translation.reshape(s, n, 1, 3).transpose(0, 1),
    )
