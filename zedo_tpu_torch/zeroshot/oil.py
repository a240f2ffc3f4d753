"""Optimization-In-the-Loop (OIL): alternate camera-ray gradient updates with
single reverse-diffusion steps along an annealed time schedule.

Port of the fast path of zedo_tpu/zeroshot/oil.py. Everything invariant
across steps is hoisted out of the loop: camera rays, confidence weights
and the 3x3 normal-equation inverse of the translation solve (`Geometry`),
the per-step time embeddings (or, on the kernel path, the per-step [5, H]
layer vectors) and the scalar coefficients c1, c2.

The fast path specializes the shipped configuration (sub-VP SDE,
euler_maruyama predictor, no corrector, probability flow, continuous labels
t*999), for which the reverse update is the deterministic affine step
    x' = x + c1*x - c2*model(x, t*999)
with c1 = 0.5*beta(t)/N and c2 = g2(t)/std(t)/N.

The step loop is a Python loop over device tensors with no host sync
inside: no .item(), no .cpu(), and its only branches depend on the step
index. With the hypotheses folded into the batch the model gets all
[S*N, 51] rows in one kernel launch per step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SDE, SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops.camera import backproject_rays
from zedo_tpu_torch.ops.gradient_field import (
    confidence_weights, flip_negative_z, normal_matrix, normal_rhs,
    perpendicular_distance,
)
from zedo_tpu_torch.ops.kernels import score_kernel as sk
from zedo_tpu_torch.ops.linalg import inv3x3

CONTINUOUS_LABEL_SCALE = 999.0  # model-facing labels are t*999 for continuous SDEs

_LATER = ("waits for a later slice of the port (ROADMAP.md Queue 1, item 6: "
          "generic OIL path and track_reproj)")


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
    # per-step reprojection trace: not ported yet
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


class OILResult(NamedTuple):
    pose: torch.Tensor  # [B, j, 3] final root-relative pose estimate
    translation: torch.Tensor  # [B, 1, 3] final solved camera translation


def _fast_supported(sde: SDE, sampler: PCSampler) -> bool:
    return (isinstance(sde, SubVPSDE)
            and sampler.predictor == "euler_maruyama"
            and sampler.corrector == "none"
            and sampler.probability_flow
            and sampler.denoise)


def run_oil(params: dict, model_cfg: score_mlp.ScoreMLPConfig, sde: SDE,
            sampler: PCSampler, x0: torch.Tensor, t0: torch.Tensor,
            cond2d: torch.Tensor, k: torch.Tensor, conf: Optional[torch.Tensor],
            cfg: OILConfig, model_apply=None) -> OILResult:
    """The full OIL loop.

    x0: [B, j, 3] rotated init pose; t0: [B, 1, 3] IPO translation;
    cond2d: [B, j, >=2]; conf: [B, j] or None."""
    if not isinstance(sampler, PCSampler):
        raise TypeError("the OIL loop requires the pc sampler")
    if cfg.track_reproj:
        raise NotImplementedError(f"OILConfig.track_reproj {_LATER}")
    standard_model = ((model_apply is None or model_apply is score_mlp.apply)
                      and not model_cfg.scale_by_sigma)
    if not (standard_model and _fast_supported(sde, sampler)):
        raise NotImplementedError(
            f"this model/sampler needs the generic OIL path, which {_LATER}")
    geo = precompute_geometry(cond2d, k, conf)
    timestamps = torch.linspace(sde.T, cfg.sampling_eps, cfg.iterations,
                                dtype=torch.float32, device=x0.device)
    return _run_oil_fast(params, model_cfg, sde, geo, x0, t0, timestamps, cfg)


def _kernel_eligible(params, model_cfg) -> bool:
    """Kernel contract: an architecture the CUDA kernel takes, bf16 weights
    and a CUDA device."""
    w = params["post_dense"]["weight"]
    return (sk.kernel_supports(model_cfg) and w.dtype == torch.bfloat16
            and w.device.type == "cuda")


def _run_oil_fast(params, model_cfg, sde: SubVPSDE, geo: Geometry, x0, t0,
                  timestamps, cfg: OILConfig) -> OILResult:
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
    c1 = (0.5 * beta * inv_n).unbind(0)
    c2 = (g2 / std * inv_n).unbind(0)

    temb_table = score_mlp.time_embedding(params, model_cfg, t * CONTINUOUS_LABEL_SCALE)

    use_kernel = cfg.use_kernel
    if use_kernel is None:
        use_kernel = _kernel_eligible(params, model_cfg)

    if use_kernel:
        packed = sk.pack_weights(params, model_cfg, dtype=model_dtype,
                                 gn_dtype=torch.float32 if cfg.gn_fp32 else None)
        # [steps, 5, H] per-step layer vectors, precomputed outside the loop
        vecs = sk.step_vectors(packed, temb_table).contiguous().unbind(0)

        def model_forward(x, i):
            out = sk.fused_score_forward(x.reshape(x.shape[0], -1), packed, vecs[i])
            return out.reshape(x.shape)
    else:
        temb = temb_table.unbind(0)

        def model_forward(x, i):
            return score_mlp.apply_with_temb(
                params, model_cfg, x.to(model_dtype), temb[i]).to(x.dtype)

    reuse = max(1, cfg.score_reuse)
    x, t_cur, out = x0, t0, None
    for i in range(cfg.iterations):
        if i >= cfg.n_fixed:
            t_cur = solve_translation_fast(geo, x)
        x = x + ray_gradient(geo, x, t_cur)
        if i % reuse == 0:
            out = model_forward(x, i)
        x = x + c1[i] * x - c2[i] * out
    return OILResult(pose=x, translation=t_cur)
