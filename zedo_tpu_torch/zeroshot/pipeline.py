"""The ZeDO zero-shot pipeline: cluster init -> IPO -> OIL, for S hypotheses.

Port of zedo_tpu/zeroshot/pipeline.py. The JAX package vmaps one
hypothesis's program over S; here the S hypotheses are folded into the
batch (rows ordered hypothesis-major, s*N + n), so IPO and OIL run once on
S*N rows and the score network sees all of them in one launch per step.
IPO keeps each hypothesis's own mean loss (zeroshot/ipo.py).
"""
from __future__ import annotations

import contextlib
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

    @classmethod
    def from_config(cls, config) -> "ZeDOConfig":
        """Build from a nested config with a ZeDO block. `use_pallas` selects
        the CUDA score kernel (`use_kernel`); `pallas_interpret` has no
        counterpart: on the CPU the kernel's wrapper runs its plain version."""
        z = config.ZeDO
        if z.get("pallas_interpret", False):
            raise ValueError(
                "ZeDO.pallas_interpret=True has no counterpart in the port: the CUDA "
                "kernel's wrapper runs its plain version on CPU tensors")
        return cls(
            ipo=IPOConfig(
                iterations=z.IPO_iterations,
                keypoint_list=tuple(z.IPO_keylist),
                rot_axes=z.RotAxes,
                t_norm=z.IPO_T,
                min_scale_t=z.IPO_minScaleT,
                max_scale_t=z.IPO_maxScaleT,
            ),
            oil=OILConfig(
                iterations=z.OIL_iterations,
                sampling_eps=z.sampling_eps,
                score_reuse=int(z.get("score_reuse", 1)),
                gn_fp32=bool(z.get("gn_fp32", False)),
                use_kernel=z.get("use_pallas", None),
            ),
        )


class SolveResult(NamedTuple):
    poses: torch.Tensor  # [N, S, j, 3]
    translations: torch.Tensor  # [N, S, 1, 3]
    # [S, steps] per-step mean pixel reprojection error of each hypothesis
    # when the solve ran with OILConfig.track_reproj; None otherwise
    reproj_px: Optional[torch.Tensor] = None


@contextlib.contextmanager
def _phase(stopwatch, name: str, device: torch.device):
    """A stopwatch phase that ends when the device has finished its work."""
    if stopwatch is None:
        yield
        return
    with stopwatch.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def fold(a: Optional[torch.Tensor], s: int) -> Optional[torch.Tensor]:
    """A per-sample tensor [N, ...] tiled to the folded rows [S*N, ...],
    hypothesis-major (row s*N + n is sample n)."""
    return None if a is None else a.repeat(s, *(1,) * (a.dim() - 1))


def _solve_folded(params, model_cfg, sde, sampler, cfg: ZeDOConfig,
                  cluster_poses, cond2d, conf, k, model_apply=None,
                  stopwatch=None, generator=None, reproj_weight=None) -> OILResult:
    """All hypotheses in one batch of S*N rows, hypothesis-major."""
    cluster_poses = torch.as_tensor(cluster_poses, dtype=cond2d.dtype,
                                    device=cond2d.device)
    s, n = cluster_poses.shape[0], cond2d.shape[0]
    # root-center each cluster pose and broadcast it over the batch
    pose0 = cluster_poses - cluster_poses[:, 0:1, :]
    pose0 = pose0[:, None].expand(s, n, *pose0.shape[1:]).reshape(s * n, *pose0.shape[1:])
    cond2d, k, conf = fold(cond2d, s), fold(k, s), fold(conf, s)

    with _phase(stopwatch, "ipo", cond2d.device):
        ipo = run_ipo(pose0, cond2d, k, cfg.ipo, n_groups=s)
        x0 = torch.einsum("bij,bnj->bni", ipo.rot_mat, pose0)
    with _phase(stopwatch, "oil", cond2d.device):
        return run_oil(params, model_cfg, sde, sampler, x0, ipo.translation,
                       cond2d, k, conf, cfg.oil, model_apply=model_apply,
                       generator=generator, reproj_weight=fold(reproj_weight, s), n_groups=s)


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
          model_apply=None, stopwatch=None, generator=None,
          reproj_weight=None) -> SolveResult:
    """All S hypotheses [S, j, 3] over cond2d [N, j, >=2], k [N, 3, 3];
    returns [N, S, j, 3] poses, [N, S, 1, 3] translations and, under
    OILConfig.track_reproj, the [S, steps] reprojection trace.

    stopwatch: an optional utils.profiling.Stopwatch that times IPO and OIL
    as its phases "ipo" and "oil", each ending in a device synchronize.
    generator: the noise of the generic OIL path; reproj_weight: optional
    [N] per-sample weights of the trace, summing to 1."""
    res = _solve_folded(params, model_cfg, sde, sampler, cfg, cluster_poses,
                        cond2d, conf, k, model_apply, stopwatch, generator, reproj_weight)
    return unfold_result(res, len(cluster_poses), cfg.oil.track_reproj)


def unfold_result(res: OILResult, s: int, track_reproj: bool) -> SolveResult:
    """The OIL result of S*N folded rows as [N, S, ...]."""
    n = res.pose.shape[0] // s
    return SolveResult(
        poses=res.pose.reshape(s, n, *res.pose.shape[1:]).transpose(0, 1),
        translations=res.translation.reshape(s, n, 1, 3).transpose(0, 1),
        reproj_px=res.reproj_px if track_reproj else None,
    )
