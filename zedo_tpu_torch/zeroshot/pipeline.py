"""The ZeDO zero-shot pipeline: cluster init -> IPO -> OIL, for S hypotheses.

Port of zedo_tpu/zeroshot/pipeline.py. The JAX package vmaps one
hypothesis's program over S; here the S hypotheses are folded into the
batch (rows ordered hypothesis-major, s*N + n), so IPO and OIL run once on
S*N rows and the score network sees all of them in one launch per step.
IPO keeps each hypothesis's own mean loss (zeroshot/ipo.py).

`solve_jit` is the compiled solve, JAX's `jax.jit(solve)`: IPO and OIL run
as compiled scans (utils/compiled.py), each step a CUDA graph replayed on the
card, cached by the static arguments and the shapes. `solve` runs the same
scan bodies in a Python loop: the oracle the compiled solve is held to.

`solve_sharded` runs the solve on a mesh of ranks (parallel/mesh.py), one
process per GPU: each rank solves its contiguous block of the N poses (JAX's
P("data") placement) with `solve_jit`, so its rows are those of `solve` on
that block alone, and the result is gathered to every rank by one all-gather
outside the graphs (JAX's `jax.jit(shard_map(solve))`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.parallel import collectives
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
                  stopwatch=None, generator=None, reproj_weight=None,
                  compiled: bool = False) -> OILResult:
    """All hypotheses in one batch of S*N rows, hypothesis-major."""
    cluster_poses = torch.as_tensor(cluster_poses, dtype=cond2d.dtype,
                                    device=cond2d.device)
    s, n = cluster_poses.shape[0], cond2d.shape[0]
    # root-center each cluster pose and broadcast it over the batch
    pose0 = cluster_poses - cluster_poses[:, 0:1, :]
    pose0 = pose0[:, None].expand(s, n, *pose0.shape[1:]).reshape(s * n, *pose0.shape[1:])
    cond2d, k, conf = fold(cond2d, s), fold(k, s), fold(conf, s)

    with _phase(stopwatch, "ipo", cond2d.device):
        ipo = run_ipo(pose0, cond2d, k, cfg.ipo, n_groups=s, compiled=compiled)
        x0 = torch.einsum("bij,bnj->bni", ipo.rot_mat, pose0)
    with _phase(stopwatch, "oil", cond2d.device):
        return run_oil(params, model_cfg, sde, sampler, x0, ipo.translation,
                       cond2d, k, conf, cfg.oil, model_apply=model_apply,
                       generator=generator, reproj_weight=fold(reproj_weight, s), n_groups=s,
                       compiled=compiled)


def solve_one_hypothesis(params: dict, model_cfg: score_mlp.ScoreMLPConfig,
                         sde: SDE, sampler: PCSampler, cfg: ZeDOConfig,
                         cluster_pose: torch.Tensor, cond2d: torch.Tensor,
                         conf: Optional[torch.Tensor], k: torch.Tensor,
                         model_apply=None, generator=None,
                         reproj_weight=None) -> OILResult:
    """One hypothesis [j, 3] over the full batch: OILResult of [N, ...].
    generator: the noise of the generic OIL path; reproj_weight: optional
    [N] per-sample weights of the trace, summing to 1."""
    return _solve_folded(params, model_cfg, sde, sampler, cfg,
                         torch.as_tensor(cluster_pose)[None], cond2d, conf, k,
                         model_apply, generator=generator, reproj_weight=reproj_weight)


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


def solve_jit(params: dict, model_cfg: score_mlp.ScoreMLPConfig, sde: SDE,
              sampler: PCSampler, cfg: ZeDOConfig, cluster_poses: torch.Tensor,
              cond2d: torch.Tensor, conf: Optional[torch.Tensor], k: torch.Tensor,
              model_apply=None, generator=None, reproj_weight=None,
              stopwatch=None) -> SolveResult:
    """The compiled solve: `solve`'s arguments and result, IPO and OIL as
    compiled scans. The first call with new static arguments (model_cfg,
    sde, sampler, cfg, model_apply) or new shapes captures the steps as CUDA
    graphs; later calls copy their tensors into the graphs' static buffers
    (new params values capture nothing anew) and replay. Bit-equal to
    `solve` on the same inputs; the generic path's draws come from
    `generator` as in `solve`, which stands after the call where `solve`
    leaves it. On CPU tensors the scan bodies run eagerly. stopwatch: as in
    `solve`, "ipo" and "oil" time the replays (and a first call's capture)."""
    res = _solve_folded(params, model_cfg, sde, sampler, cfg, cluster_poses,
                        cond2d, conf, k, model_apply, stopwatch, generator, reproj_weight,
                        compiled=True)
    return unfold_result(res, len(cluster_poses), cfg.oil.track_reproj)


def unfold_result(res: OILResult, s: int, track_reproj: bool) -> SolveResult:
    """The OIL result of S*N folded rows as [N, S, ...]."""
    n = res.pose.shape[0] // s
    return SolveResult(
        poses=res.pose.reshape(s, n, *res.pose.shape[1:]).transpose(0, 1),
        translations=res.translation.reshape(s, n, 1, 3).transpose(0, 1),
        reproj_px=res.reproj_px if track_reproj else None,
    )


def _pad_aware_reproj_weight(mesh, data_axis: str, cfg: ZeDOConfig, row_mask):
    """[N] per-row trace weights from pad_batch's real-row mask, or None for
    uniform: mask * D / n_real, so that after each rank's weighted sum and
    the mean over the D ranks of the data axis the trace is the mean over
    the real rows only."""
    if not cfg.oil.track_reproj or row_mask is None:
        return None
    m = np.asarray(row_mask, np.float32)
    n_real = float(m.sum())
    if n_real == 0:
        raise ValueError("row_mask marks no real rows")
    return m * np.float32(mesh.axis_size(data_axis) / n_real)


def shard_rows(mesh, data_axis: str, n: int, *arrays):
    """This rank's block of rows of each global [N, ...] array (a tensor or
    numpy; None stays None) as a tensor on mesh.device."""
    rows = mesh.row_slice(n, data_axis)

    def put(a):
        if a is None:
            return None
        return torch.as_tensor(a[rows]).to(mesh.device)

    return [put(a) for a in arrays]


def prebuild_kernel(mesh, params, model_cfg) -> None:
    """Build the score kernel on the mesh's first rank before the others load
    it, where the OIL loop will launch it."""
    from zedo_tpu_torch.zeroshot.oil import _kernel_eligible

    if mesh.device.type == "cuda" and _kernel_eligible(params, model_cfg):
        from zedo_tpu_torch.ops.kernels import build

        collectives.main_first(mesh, lambda: build.build(("score_mlp",)))


def reduce_trace(res: SolveResult, mesh, data_axis: str) -> SolveResult:
    """The [S, steps] trace of each rank's rows averaged over the data axis:
    the solve's one collective besides the final gather."""
    if res.reproj_px is None:
        return res
    return res._replace(reproj_px=collectives.pmean(res.reproj_px, mesh, data_axis))


def gather_result(res: SolveResult, mesh, data_axis: str) -> SolveResult:
    """Each rank's [n, S, ...] poses and translations gathered to the
    global [N, S, ...] on every rank, in one all-gather."""
    n, s, j = res.poses.shape[:3]
    packed = torch.cat([res.poses.reshape(n, s, -1), res.translations.reshape(n, s, -1)], -1)
    full = collectives.all_gather(packed, mesh, data_axis)
    return res._replace(poses=full[..., :j * 3].reshape(-1, s, j, 3),
                        translations=full[..., j * 3:].reshape(-1, s, 1, 3))


def solve_sharded(mesh, params: dict, model_cfg: score_mlp.ScoreMLPConfig, sde: SDE,
                  sampler: PCSampler, cfg: ZeDOConfig, cluster_poses, cond2d, conf, k,
                  model_apply=None, generator=None, data_axis: str = "data", row_mask=None,
                  stopwatch=None) -> SolveResult:
    """The solve on a mesh: every rank passes the same global inputs (SPMD),
    solves its block of the N poses over `data_axis` with `solve_jit` (weights
    and cluster poses replicated, the kernel on its own device), and gets
    the global [N, S, j, 3] result; ranks on other axes solve the same
    block. No collective runs inside the solve except, under
    OILConfig.track_reproj, the mean of the [S, steps] trace over the data
    axis (IPO's loss stays a mean over each rank's own rows, as in JAX's
    shard_map). generator: the generic path's noise, seeded alike on every
    rank, which draws for its own rows.

    N must be divisible by the data-axis size: pad with
    data.sharding.pad_batch and pass its mask as `row_mask`, so that the
    trace averages over the real rows only (the poses of the pad rows are
    dropped by sharding.unpad)."""
    weight = _pad_aware_reproj_weight(mesh, data_axis, cfg, row_mask)
    cond2d, conf, k, weight = shard_rows(mesh, data_axis, len(cond2d), cond2d, conf, k, weight)
    prebuild_kernel(mesh, params, model_cfg)
    res = solve_jit(params, model_cfg, sde, sampler, cfg, cluster_poses, cond2d, conf, k,
                    model_apply=model_apply, generator=generator, reproj_weight=weight,
                    stopwatch=stopwatch)
    return gather_result(reduce_trace(res, mesh, data_axis), mesh, data_axis)
