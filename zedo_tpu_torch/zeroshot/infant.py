"""ZeDO-i: the infant-pose variant of the zero-shot pipeline (port of
zedo_tpu/zeroshot/infant.py).

Deltas from the adult pipeline:
  * pelvis = joint 0 (mini) or mean(joints 0, 3) (syrip);
  * the OIL init pose is NOT the cluster pose: it is the back-projected
    camera rays (raw K^-1 [u, v, 1]) divided by the pelvis-ray norm, scaled
    to ||T|| and pelvis-centred, then rotated by IPO's rotation; the cluster
    pose, not root-centred, only drives the IPO rotation fit;
  * the translation stays fixed until the final (1000 - refine_t_from)/1000
    of the schedule, then is re-solved every step
    (fixed_t_steps = refine_t_from * iterations // 1000);
  * confidences unused (conf=None).

As in `pipeline.solve`, the S hypotheses are folded into the batch (rows
hypothesis-major, s*N + n), so IPO and OIL run once on S*N rows.
`solve_infant_jit` is the compiled solve (as `pipeline.solve_jit`; JAX
compiles the infant solve under `jax.jit(shard_map(...))`), and
`solve_infant_sharded` runs it on a mesh of ranks, as
`pipeline.solve_sharded` runs the adult solve.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops.linalg import inv_intrinsics
from zedo_tpu_torch.utils import profiling
from zedo_tpu_torch.zeroshot.ipo import init_translation, run_ipo
from zedo_tpu_torch.zeroshot.oil import OILResult, run_oil
from zedo_tpu_torch.zeroshot import pipeline
from zedo_tpu_torch.zeroshot.pipeline import SolveResult, ZeDOConfig, fold, unfold_result

# skeleton of the max-bone-length diagnostic
INFANT_SKELETON = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [9, 10], [10, 11]]


def find_closest(data: torch.Tensor, dataset: torch.Tensor) -> torch.Tensor:
    """Nearest pose of `dataset` [M, j, 3] to `data` [j, 3] by summed
    per-joint distance."""
    dist = torch.linalg.vector_norm(dataset - data[None], dim=-1).sum(-1)
    return dataset[torch.argmin(dist)]


def _pelvis(v: torch.Tensor, pelvis_mode: str) -> torch.Tensor:
    """[B, 1, c] pelvis of [B, j, c]: joint 0, or the mean of joints 0 and 3
    (the syrip 12-joint convention)."""
    if pelvis_mode == "joint0":
        return v[:, 0:1]
    if pelvis_mode == "mean03":
        return (v[:, 0:1] + v[:, 3:4]) / 2
    raise ValueError(pelvis_mode)


def pelvis_2d(cond2d: torch.Tensor, pelvis_mode: str) -> torch.Tensor:
    """[B, 2] pelvis pixel."""
    return _pelvis(cond2d[..., :2], pelvis_mode)[:, 0]


def init_translation_infant(cond2d, k, t_norm, pelvis_mode: str) -> torch.Tensor:
    """Pelvis-ray translation init with the infant pelvis convention."""
    return init_translation(cond2d, k, t_norm, pelvis=pelvis_2d(cond2d, pelvis_mode))


def _rotate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] @ each point of [B, n, 3], a broadcast multiply-sum over the
    3-long axis (no TF32 setting rounds it)."""
    return (m[:, None, :, :] * v[:, :, None, :]).sum(-1)


def ray_init_pose(cond2d, k, t, pelvis_mode: str) -> torch.Tensor:
    """Back-projected rays scaled to ||T||, pelvis-centred. The rays are NOT
    z-normalized: raw K^-1 [u, v, 1], divided by the pelvis-ray norm."""
    hom = torch.cat([cond2d[..., :2], torch.ones_like(cond2d[..., :1])], dim=-1)
    ray = _rotate(inv_intrinsics(k), hom)
    ray = ray / torch.linalg.vector_norm(_pelvis(ray, pelvis_mode), dim=-1, keepdim=True)
    ray = ray * torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return ray - _pelvis(ray, pelvis_mode)


def max_bone_length(pose: torch.Tensor) -> torch.Tensor:
    """Diagnostic: the longest bone of INFANT_SKELETON per sample, [B]."""
    a, b = zip(*INFANT_SKELETON)
    return torch.linalg.vector_norm(pose[:, list(a)] - pose[:, list(b)], dim=-1).amax(-1)


def _with_condition(model_apply, condition: torch.Tensor):
    """model_apply with `condition` wherever the sampler passes none (the
    sampler's steps pass condition=None)."""

    def apply_fn(params, cfg, x, labels, cond_arg=None, mask=None, **kw):
        return model_apply(params, cfg, x, labels,
                           condition if cond_arg is None else cond_arg, mask, **kw)

    return apply_fn


def _solve_folded_infant(params, model_apply, model_cfg, sde, sampler, cfg: ZeDOConfig,
                         cluster_poses, cond2d, k, pelvis_mode, refine_t_from, generator,
                         reproj_weight, condition, stopwatch, compiled=False) -> OILResult:
    """The span `zedo.solve`, with `zedo.ipo` and `zedo.oil` inside."""
    with profiling.annotate("zedo.solve"):
        cluster_poses = torch.as_tensor(cluster_poses, dtype=cond2d.dtype, device=cond2d.device)
        s, n = cluster_poses.shape[0], cond2d.shape[0]
        pose0 = cluster_poses[:, None].expand(s, n, *cluster_poses.shape[1:])
        pose0 = pose0.reshape(s * n, *cluster_poses.shape[1:])
        cond2d, k = fold(cond2d, s), fold(k, s)

        with profiling.phase(stopwatch, "ipo", cond2d.device):
            t0 = init_translation_infant(cond2d, k, cfg.ipo.t_norm, pelvis_mode)
            ipo = run_ipo(pose0, cond2d, k, cfg.ipo, t=t0, n_groups=s, compiled=compiled)
            x0 = _rotate(ipo.rot_mat, ray_init_pose(cond2d, k, ipo.translation, pelvis_mode))
        # the reference re-solves T from step 950 of its fixed 1000-step
        # schedule: the same fraction of the configured iterations
        fixed = (refine_t_from * cfg.oil.iterations) // 1000
        oil_cfg = dataclasses.replace(cfg.oil, fixed_t_steps=fixed)
        with profiling.phase(stopwatch, "oil", cond2d.device):
            return run_oil(params, model_cfg, sde, sampler, x0, ipo.translation, cond2d, k, None,
                           oil_cfg, model_apply=model_apply, generator=generator,
                           reproj_weight=fold(reproj_weight, s), n_groups=s,
                           # each folded row conditioned on its own sample's keypoints
                           condition=fold(condition, s), compiled=compiled,
                           stopwatch=stopwatch)


def solve_one_hypothesis_infant(params: dict, model_apply, model_cfg: score_mlp.ScoreMLPConfig,
                                sde: SDE, sampler: PCSampler, cfg: ZeDOConfig,
                                cluster_pose: torch.Tensor, cond2d: torch.Tensor,
                                k: torch.Tensor, pelvis_mode: str = "joint0",
                                refine_t_from: int = 950,
                                generator: Optional[torch.Generator] = None,
                                reproj_weight: Optional[torch.Tensor] = None,
                                condition: Optional[torch.Tensor] = None) -> OILResult:
    """One hypothesis [j, 3] (not root-centred) over the batch: an
    OILResult of [N, ...], with [1, steps] diagnostics."""
    return _solve_folded_infant(params, model_apply, model_cfg, sde, sampler, cfg,
                                torch.as_tensor(cluster_pose)[None], cond2d, k, pelvis_mode,
                                refine_t_from, generator, reproj_weight, condition, None)


def solve_infant(params, model_apply, model_cfg, sde, sampler, cfg: ZeDOConfig,
                 cluster_poses, cond2d, k, pelvis_mode="joint0", refine_t_from=950,
                 generator=None, reproj_weight=None, condition=None,
                 stopwatch=None) -> SolveResult:
    """All hypotheses [S, j, 3] over cond2d [N, j, >=2], k [N, 3, 3]:
    [N, S, j, 3] poses, [N, S, 1, 3] translations and, under
    OILConfig.track_reproj, the [S, steps] reprojection trace.

    model_apply: score_mlp.apply or control_mlp.apply (on bf16 weights on the
    card, its kernel: oil.model_path) or score_mlp_cond.apply (the generic path).
    condition: optional per-sample model condition [N, j, c] (the --cond
    CLI's normalized 2D keypoints), tiled with the rows.
    generator: the generic path's noise; reproj_weight: optional [N]
    per-sample trace weights summing to 1; stopwatch: as in pipeline.solve."""
    res = _solve_folded_infant(params, model_apply, model_cfg, sde, sampler, cfg,
                               cluster_poses, cond2d, k, pelvis_mode, refine_t_from,
                               generator, reproj_weight, condition, stopwatch)
    return unfold_result(res, len(cluster_poses), cfg.oil.track_reproj)


def solve_infant_jit(params, model_apply, model_cfg, sde, sampler, cfg: ZeDOConfig,
                     cluster_poses, cond2d, k, pelvis_mode="joint0", refine_t_from=950,
                     generator=None, reproj_weight=None, condition=None,
                     stopwatch=None) -> SolveResult:
    """The compiled infant solve: `solve_infant`'s arguments and result, IPO
    and OIL as compiled scans (CUDA graphs on the card, cached as
    `pipeline.solve_jit` caches them), bit-equal to `solve_infant`."""
    res = _solve_folded_infant(params, model_apply, model_cfg, sde, sampler, cfg,
                               cluster_poses, cond2d, k, pelvis_mode, refine_t_from,
                               generator, reproj_weight, condition, stopwatch, compiled=True)
    return unfold_result(res, len(cluster_poses), cfg.oil.track_reproj)


def solve_infant_sharded(mesh, params, model_apply, model_cfg, sde, sampler, cfg: ZeDOConfig,
                         cluster_poses, cond2d, k, pelvis_mode="joint0", refine_t_from=950,
                         generator=None, condition=None, data_axis: str = "data",
                         row_mask=None, stopwatch=None) -> SolveResult:
    """The infant solve on a mesh (mirror of pipeline.solve_sharded, which
    see): every rank passes the same global inputs, solves its block of the
    N frames with `solve_infant_jit` and gets the global result. `condition`
    [N, j, c] is sharded with the batch; the conditional model takes the
    generic path on each rank, with `generator` seeded alike on every rank,
    and the ControlNet adapter on bf16 weights kernel #3; the first rank
    builds the kernels first (pipeline.prebuild_kernel). Under
    OILConfig.track_reproj the [S, steps] trace is averaged over the data
    axis (pad N with data.sharding.pad_batch and pass its mask as
    `row_mask`)."""
    weight = pipeline._pad_aware_reproj_weight(mesh, data_axis, cfg, row_mask)
    cond2d, k, condition, weight = pipeline.shard_rows(mesh, data_axis, len(cond2d), cond2d,
                                                       k, condition, weight)
    pipeline.prebuild_kernel(mesh)
    res = solve_infant_jit(params, model_apply, model_cfg, sde, sampler, cfg, cluster_poses,
                           cond2d, k, pelvis_mode=pelvis_mode, refine_t_from=refine_t_from,
                           generator=generator, reproj_weight=weight, condition=condition,
                           stopwatch=stopwatch)
    return pipeline.gather_result(pipeline.reduce_trace(res, mesh, data_axis), mesh, data_axis)
