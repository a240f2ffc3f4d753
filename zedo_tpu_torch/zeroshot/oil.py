"""Optimization-In-the-Loop (OIL): alternate camera-ray gradient updates with
single reverse-diffusion steps along an annealed time schedule.

Port of zedo_tpu/zeroshot/oil.py. Everything invariant across steps is
hoisted out of the loop: camera rays, confidence weights and the 3x3
normal-equation inverse of the translation solve (`Geometry`).

The fast path specializes the shipped configuration (sub-VP SDE,
euler_maruyama predictor, no corrector, probability flow, continuous labels
t*999) with the plain ScoreMLP, for which the reverse update is the
deterministic affine step
    x' = x + c1*x - c2*model(x, t*999)
with c1 = 0.5*beta(t)/N and c2 = g2(t)/std(t)/N, the per-step time
embeddings (or, on the kernel path, the per-step [5, H] layer vectors)
precomputed. Every other model (the ControlNet and conditional adapters, a
`scale_by_sigma` model) or sampler takes the generic path: one
`PCSampler.zedo_pc_step` a step through the predictor/corrector registries,
with noise from a per-call `torch.Generator` drawn in step order.

Each path's step is a scan body (utils/compiled.py), JAX's `lax.scan`
body: the carry is the pose, the translation and, under score_reuse, the
held model output; the per-step inputs (c1, c2 and the step vectors or time
embeddings on the fast path, the timestamps on the generic path) are read
from device tables at the device step counter, and the per-step diagnostics
(`grad_norms`, and `reproj_px` under `track_reproj`) are written into
[steps, G] tables at the same counter. The step index reaches the body only
as the host's choice of variant: whether the step re-solves the translation
(`i >= n_fixed`) and whether it evaluates the model (`i % score_reuse ==
0`), at most four bodies. No step reads the device from the host.
`run_oil(compiled=True)` replays each variant as a CUDA graph on the card;
the eager loop runs the same bodies. With the hypotheses folded into the
batch (`n_groups`) the model gets all [S*N, j*3] rows in one call per step,
and each diagnostic is reduced per hypothesis, over its own N rows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.score import CONTINUOUS_LABEL_SCALE, get_score_fn, split_score_fn
from zedo_tpu_torch.diffusion.sde import SDE, SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops.camera import backproject_rays
from zedo_tpu_torch.ops.gradient_field import (
    confidence_weights, flip_negative_z, normal_matrix, normal_rhs,
    perpendicular_distance,
)
from zedo_tpu_torch.ops.kernels import score_kernel as sk
from zedo_tpu_torch.ops.linalg import inv3x3
from zedo_tpu_torch.utils.compiled import scan


@dataclasses.dataclass(frozen=True)
class OILConfig:
    """Mirrors config.ZeDO OIL keys."""

    iterations: int = 1000
    sampling_eps: float = 0.01
    # steps that keep the IPO translation before re-solving each step;
    # the reference uses iterations // 5
    fixed_t_steps: Optional[int] = None
    # None = auto: the fused CUDA score kernel when the params are bf16, the
    # device is CUDA and the architecture is one the kernel takes. True
    # forces the kernel wrapper (its plain version for CPU tensors)
    use_kernel: Optional[bool] = None
    # evaluate the score network every k-th step and reuse its output in
    # between (opt-in; 1 = exact reference dynamics)
    score_reuse: int = 1
    # GroupNorm statistics in f32 with bf16 weights (exact-GN mode); the
    # default reduces them in the weight dtype, as the TPU kernel does, in
    # the CUDA kernel and its plain version alike
    gn_fp32: bool = False
    # record the mean |K(x+T) - cond2d| pixel reprojection error of each
    # step, at step entry (before the T re-solve); off by default: it adds
    # a projection of all rows to every step
    track_reproj: bool = False

    @property
    def n_fixed(self) -> int:
        return self.iterations // 5 if self.fixed_t_steps is None else self.fixed_t_steps


class Geometry(NamedTuple):
    """Step-invariant geometric precomputation."""

    rays_unit: torch.Tensor  # [B, j, 3] unit camera rays
    rx: torch.Tensor  # [B, j] z-normalized ray x
    ry: torch.Tensor  # [B, j]
    w: torch.Tensor  # [B, j] conf^4 weights (or ones)
    ata_inv: torch.Tensor  # [B, 3, 3] inverse normal matrix for the T solve


def precompute_geometry(cond2d: torch.Tensor, k: torch.Tensor,
                        conf: Optional[torch.Tensor]) -> Geometry:
    """Everything of the gradient field that does not depend on x."""
    rays = backproject_rays(cond2d[..., :2], k)  # z == 1
    rays_unit = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    rx, ry = rays[..., 0], rays[..., 1]
    w = confidence_weights(conf, rx)
    return Geometry(rays_unit=rays_unit, rx=rx, ry=ry, w=w,
                    ata_inv=inv3x3(normal_matrix(rx, ry, w)))


def solve_translation_fast(geo: Geometry, key3d: torch.Tensor) -> torch.Tensor:
    """T = ATA^-1 ATb with the precomputed inverse, z-flipped. [B, 1, 3]."""
    atb = normal_rhs(geo.rx, geo.ry, geo.w, key3d)
    t = torch.einsum("bij,bj->bi", geo.ata_inv, atb)
    return flip_negative_z(t)[:, None, :]


def ray_gradient(geo: Geometry, key3d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Perpendicular-foot gradient toward the rays."""
    return perpendicular_distance(key3d + t, geo.rays_unit)


def reprojection_error(x: torch.Tensor, t: torch.Tensor, k: torch.Tensor,
                       cond2d: torch.Tensor) -> torch.Tensor:
    """[B, j, 2] |K(x + t) - cond2d| in pixels. The projection is a
    broadcast multiply-sum over the 3-long axis, so no TF32 setting rounds
    it (JAX computes it at Precision.HIGHEST)."""
    proj = (k[:, None, :, :] * (x + t)[:, :, None, :]).sum(-1)
    return (proj[..., :2] / proj[..., 2:] - cond2d[..., :2]).abs()


class OILResult(NamedTuple):
    pose: torch.Tensor  # [B, j, 3] final root-relative pose estimate
    translation: torch.Tensor  # [B, 1, 3] final solved camera translation
    # [G, steps] mean ray-gradient norm of each step, per group of rows
    # (hypothesis) folded into the batch
    grad_norms: torch.Tensor
    # [G, steps] mean pixel reprojection error of each step at its entry
    # under OILConfig.track_reproj, else zeros
    reproj_px: torch.Tensor


def _trace_tables(cfg: OILConfig, n_groups: int, device) -> dict:
    """The scan's per-step outputs: [steps, G] tables of zeros."""
    shape = (cfg.iterations, n_groups)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("grad_norms", "reproj_px")}


def _trace_entry(consts, ys, counter, x, t_cur, track_reproj: bool, n_groups: int) -> None:
    """The step's mean pixel reprojection error at its entry, per group of
    rows, into reproj_px at the counter (under track_reproj)."""
    if not track_reproj:
        return
    err = reprojection_error(x, t_cur, consts["k"], consts["cond2d"])
    weight = consts["reproj_weight"]
    if weight is None:
        value = torch.mean(err.reshape(n_groups, -1), dim=1)
    else:
        # per-row weights summing to 1 within each group
        rows = weight * err.reshape(err.shape[0], -1).mean(1)
        value = torch.sum(rows.reshape(n_groups, -1), dim=1)
    ys["reproj_px"].index_copy_(0, counter, value[None])


def _trace_gradient(ys, counter, grad, n_groups: int) -> None:
    norms = torch.linalg.vector_norm(grad, dim=-1)
    ys["grad_norms"].index_copy_(0, counter, torch.mean(norms.reshape(n_groups, -1), dim=1)[None])


def _at(table: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """The counter's row of a per-step table, without its step axis."""
    return table.index_select(0, counter)[0]


def _schedule(cfg: OILConfig) -> tuple:
    """Each step's variant: (re-solve the translation, evaluate the model)."""
    reuse = max(1, cfg.score_reuse)
    return tuple((i >= cfg.n_fixed, i % reuse == 0) for i in range(cfg.iterations))


def _fast_supported(sde: SDE, sampler: PCSampler) -> bool:
    return (isinstance(sde, SubVPSDE)
            and sampler.predictor == "euler_maruyama"
            and sampler.corrector == "none"
            and sampler.probability_flow
            and sampler.denoise)


def run_oil(params: dict, model_cfg: score_mlp.ScoreMLPConfig, sde: SDE,
            sampler: PCSampler, x0: torch.Tensor, t0: torch.Tensor,
            cond2d: torch.Tensor, k: torch.Tensor, conf: Optional[torch.Tensor],
            cfg: OILConfig, model_apply=None, generator: Optional[torch.Generator] = None,
            reproj_weight: Optional[torch.Tensor] = None, n_groups: int = 1,
            condition: Optional[torch.Tensor] = None, compiled: bool = False) -> OILResult:
    """The full OIL loop.

    x0: [B, j, 3] rotated init pose; t0: [B, 1, 3] IPO translation;
    cond2d: [B, j, >=2]; conf: [B, j] or None.
    model_apply: a score_mlp.apply-compatible function (the ControlNet or
    conditional adapter); any model but the plain ScoreMLP takes the generic
    path. generator: the noise of the generic path (a generator on x0's
    device; default: seeded 0); the fast path draws none.
    reproj_weight: optional [B] per-row weights of the track_reproj trace,
    summing to 1 within each group (None = uniform).
    n_groups: groups (hypotheses) of B / n_groups contiguous rows folded into
    the batch; the diagnostics come back [n_groups, steps].
    condition: optional [B, j, c] model condition, passed to model_apply
    wherever the sampler passes none (the generic path).
    compiled: the step as a compiled scan (CUDA graphs on the card)."""
    if not isinstance(sampler, PCSampler):
        raise TypeError(
            "the OIL loop requires the pc sampler (one corrector + predictor step per "
            "iteration); the ODE sampler is only valid for full-loop sampling")
    if cond2d.shape[0] % n_groups:
        raise ValueError(f"batch {cond2d.shape[0]} does not split into {n_groups} groups")
    timestamps = torch.linspace(sde.T, cfg.sampling_eps, cfg.iterations,
                                dtype=torch.float32, device=x0.device)
    consts = {"geo": precompute_geometry(cond2d, k, conf)}
    if cfg.track_reproj:
        consts.update(k=k, cond2d=cond2d, reproj_weight=reproj_weight)
    carry = {"x": x0, "t": t0}
    if cfg.score_reuse > 1:
        carry["out"] = torch.zeros_like(x0)
    standard_model = ((model_apply is None or model_apply is score_mlp.apply)
                      and condition is None and not model_cfg.scale_by_sigma)
    if standard_model and _fast_supported(sde, sampler):
        model_consts, static = _fast_program(params, model_cfg, sde, timestamps, cfg)
        consts.update(model_consts)
        body = functools.partial(_fast_body, cfg=cfg, n_groups=n_groups, **static)
    else:
        if generator is None:
            generator = torch.Generator(device=x0.device).manual_seed(0)
        consts.update(ts=timestamps, params=params, condition=condition)
        body = functools.partial(_generic_body, cfg=cfg, n_groups=n_groups, sde=sde,
                                 sampler=sampler, model_cfg=model_cfg,
                                 model_apply=model_apply or score_mlp.apply)
    carry, ys = scan(body, _schedule(cfg), carry, consts, _trace_tables(cfg, n_groups, x0.device),
                     generator=None if body.func is _fast_body else generator,
                     compiled=compiled)
    return OILResult(pose=carry["x"], translation=carry["t"], grad_norms=ys["grad_norms"].t(),
                     reproj_px=ys["reproj_px"].t())


def _kernel_eligible(params, model_cfg) -> bool:
    """Kernel contract: an architecture the CUDA kernel takes, bf16 weights
    and a CUDA device."""
    w = params["post_dense"]["weight"]
    return (sk.kernel_supports(model_cfg) and w.dtype == torch.bfloat16
            and w.device.type == "cuda")


def _geometry_step(consts, ys, counter, resolve: bool, x, t_cur, cfg: OILConfig, n_groups: int):
    """The step's translation re-solve and ray gradient: (x + grad, t)."""
    geo = consts["geo"]
    _trace_entry(consts, ys, counter, x, t_cur, cfg.track_reproj, n_groups)
    if resolve:
        t_cur = solve_translation_fast(geo, x)
    grad = ray_gradient(geo, x, t_cur)
    _trace_gradient(ys, counter, grad, n_groups)
    return x + grad, t_cur


def _fast_program(params, model_cfg, sde: SubVPSDE, timestamps, cfg: OILConfig):
    """The fast path's per-step tables and model operands (computed once per
    solve, outside the scan) and its static arguments."""
    # model compute dtype follows the params; geometry stays f32
    model_dtype = params["post_dense"]["weight"].dtype
    t = timestamps
    beta = sde.beta_min + t * (sde.beta_max - sde.beta_min)
    discount = 1.0 - torch.exp(-2.0 * sde.beta_min * t - (sde.beta_max - sde.beta_min) * t ** 2)
    g2 = beta * discount
    lmc = -0.25 * t ** 2 * (sde.beta_max - sde.beta_min) - 0.5 * t * sde.beta_min
    std = 1.0 - torch.exp(2.0 * lmc)
    # x_mean = x + drift*dt with drift = -0.5*beta*x - g^2*score,
    # score = -model_out/std, dt = -1/N  =>  x_mean = x + c1*x - c2*model_out
    inv_n = 1.0 / sde.n
    consts = {"c1": 0.5 * beta * inv_n, "c2": g2 / std * inv_n}

    temb_table = score_mlp.time_embedding(params, model_cfg, t * CONTINUOUS_LABEL_SCALE)

    use_kernel = cfg.use_kernel
    if use_kernel is None:
        use_kernel = _kernel_eligible(params, model_cfg)
    if use_kernel:
        packed = sk.pack_weights(params, model_cfg, dtype=model_dtype,
                                 gn_dtype=torch.float32 if cfg.gn_fp32 else None)
        # [steps, 5, H] per-step layer vectors, precomputed outside the scan
        consts.update(model=packed, steps=sk.step_vectors(packed, temb_table).contiguous())
    else:
        consts.update(model=params, steps=temb_table)
    return consts, {"model_cfg": model_cfg, "model_dtype": model_dtype,
                    "use_kernel": bool(use_kernel)}


def _fast_body(carry, consts, ys, counter, generator, variant, *, cfg: OILConfig,
               n_groups: int, model_cfg, model_dtype, use_kernel: bool):
    """One fast-path step: geometry, the model (kernel #1 or the plain
    ScoreMLP) where the variant evaluates it, the deterministic update."""
    resolve, evaluate = variant
    x, t_cur = _geometry_step(consts, ys, counter, resolve, carry["x"], carry["t"], cfg,
                              n_groups)
    out = carry.get("out")
    if evaluate:
        step = _at(consts["steps"], counter)
        if use_kernel:
            out = sk.fused_score_forward(x.reshape(x.shape[0], -1), consts["model"], step)
            out = out.reshape(x.shape)
        else:
            out = score_mlp.apply_with_temb(consts["model"], model_cfg, x.to(model_dtype),
                                            step).to(x.dtype)
    c1, c2 = _at(consts["c1"], counter), _at(consts["c2"], counter)
    new = {"x": x + c1 * x - c2 * out, "t": t_cur}
    if "out" in carry:
        new["out"] = out
    return new


def _generic_body(carry, consts, ys, counter, generator, variant, *, cfg: OILConfig,
                  n_groups: int, sde: SDE, sampler: PCSampler, model_cfg, model_apply):
    """One generic-path step: geometry, then any predictor and corrector of
    the registries, one zedo_pc_step (the reference's dynamics exactly at
    score_reuse=1).

    score_reuse > 1: the raw network output is evaluated every k-th step
    and held in between; each step converts the held output into a score
    with the CURRENT std (diffusion.score.split_score_fn, the decomposition
    of the fast path). Within a reused step the corrector sees the held
    output too."""
    resolve, evaluate = variant
    params, fixed = consts["params"], consts["condition"]

    def model_fn(x, labels, condition, mask):
        # the fixed condition wherever the sampler passes none
        return model_apply(params, model_cfg, x, labels,
                           fixed if condition is None else condition, mask)

    x, t_cur = _geometry_step(consts, ys, counter, resolve, carry["x"], carry["t"], cfg,
                              n_groups)
    t_i = _at(consts["ts"], counter)
    new = {"t": t_cur}
    if "out" in carry:
        eval_fn, score_from_out = split_score_fn(sde, model_fn, continuous=sampler.continuous)
        out = carry["out"]
        if evaluate:
            out = eval_fn(x, t_i.expand(x.shape[0])).to(x.dtype)
        new["out"] = out

        def score_fn(x_, t_, condition=None, mask=None):
            return score_from_out(out, x_, t_)
    else:
        score_fn = get_score_fn(sde, model_fn, continuous=sampler.continuous)
    x_next, x_mean = sampler.zedo_pc_step(score_fn, generator, x, t_i)
    new["x"] = x_mean if sampler.denoise else x_next
    return new
