"""Plain PyTorch reference of ZeDO-i's ControlNet adapter, `Control_ScoreModelFC_Adv`
(ZeDO-Release lib/algorithms/advanced/control_model.py:97-382; "Efficient
Domain Adaptation via Generative Prior for 3D Infant Pose Estimation",
WACVW 2024), in its infant solve.

It imports torch alone. The solve's geometry, IPO, projection, pelvis and
precision modes are those of perfbench/reference/zedo.py, which each
function here takes as its first argument, `base` (the references of this
directory import torch, numpy and the standard library only). The network
runs in float32 with TF32 off unless `base`'s control precisions are asked
for. Two residual streams run in lockstep, the trunk h and its copy c:

    temb = SiLU(Linear(sinusoid(t * 999)))
    c  = x + SiLU(zc_layer_1(infant_cond))
    c  = pre_dense_copy(c) + pre_dense_t_copy(temb);  c0 = zc_layer_2(c)
    c  = SiLU(GN(c))
    h  = SiLU(GN(pre_dense(x) + pre_dense_t(temb) + c0))
    2 x  orc = c
         c  = dense1_copy(c) + dense1_t_copy(temb);   c1 = zc_1(c)
         c  = dense2_t_copy(temb)                     (control_model.py:341)
         c2 = zc_2(c);  c = orc + SiLU(GN(c))
         h1 = SiLU(GN(dense1(h)  + dense1_t(temb) + c1))
         h2 = SiLU(GN(dense2(h1) + dense2_t(temb) + c2));  h = h + h2
    out = post_dense(h)

A departure from the paper's ControlNet description, kept as checked in:
each block's second control layer assigns the time projection
(`c = dense2_t_copy(temb)`, `=` and not `+=`), so that block's
dense2_copy(SiLU(GN(c))) is computed by the checked-in code and thrown away;
it is not computed here. Released ZeDO-i checkpoints were trained with this
dataflow.
"""
from __future__ import annotations

import torch


def control_mlp(base, p: dict, cfg: dict, x: torch.Tensor, labels: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """The adapter on x [B, C] at labels [B] or [1] (one label shared by all
    rows: its embedding is taken once). p: f32 leaves by state_dict name."""
    groups = cfg["group_norm_groups"]
    silu = torch.nn.functional.silu

    def linear(name, a):
        return base.linear(p, name, a, precision)

    def gn(name, a):
        return torch.nn.functional.group_norm(a, groups, p[f"{name}.weight"],
                                              p[f"{name}.bias"], base.GN_EPS)

    temb = silu(linear("shared_time_embed.0", base.sinusoid(labels, cfg["embed_dim"])))
    c = x + silu(linear("zc_layer_1", p["infant_cond"][None]))
    c = linear("pre_dense_copy", c) + linear("pre_dense_t_copy", temb)
    c0 = linear("zc_layer_2", c)
    c = silu(gn("pre_gnorm_copy", c))
    h = silu(gn("pre_gnorm", linear("pre_dense", x) + linear("pre_dense_t", temb) + c0))
    for b in range(1, cfg["n_blocks"] + 1):
        orc = c
        c = linear(f"b{b}_dense1_copy", c) + linear(f"b{b}_dense1_t_copy", temb)
        c1 = linear(f"zc_b{b}_1", c)
        c = linear(f"b{b}_dense2_t_copy", temb).expand(orc.shape)
        c2 = linear(f"zc_b{b}_2", c)
        c = orc + silu(gn(f"b{b}_gnorm2_copy", c))
        h1 = silu(gn(f"b{b}_gnorm1",
                     linear(f"b{b}_dense1", h) + linear(f"b{b}_dense1_t", temb) + c1))
        h2 = silu(gn(f"b{b}_gnorm2",
                     linear(f"b{b}_dense2", h1) + linear(f"b{b}_dense2_t", temb) + c2))
        h = h + h2
    return linear("post_dense", h)


def oil(base, p, cfg, sde, x, t_cur, px, k, conf, iterations: int, fixed_steps: int,
        precision: str = "f32", trace_groups=None):
    """`base.oil` with the adapter in the prior's place: the camera-ray steps,
    each with one probability-flow Euler step. Returns (pose, translation,
    trace [groups, steps] or None)."""
    r, j, _ = x.shape
    ray = base.rays(px[..., :2], k)
    ray = ray / ray[..., 2:]
    unit = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    rx, ry = ray[..., 0], ray[..., 1]
    w = torch.ones_like(rx) if conf is None else conf.clamp(1e-4, 1.0) ** 4
    sw, swrx, swry = w.sum(-1), (w * rx).sum(-1), (w * ry).sum(-1)
    swr2 = (w * (rx * rx + ry * ry)).sum(-1)
    zero = torch.zeros_like(sw)
    ata = torch.stack([sw, zero, -swrx, zero, sw, -swry, -swrx, -swry, swr2], -1)
    ata_inv = torch.linalg.inv(ata.reshape(r, 3, 3))
    times, c1, c2 = base.step_coefficients(sde, iterations, x.device)
    trace = None
    if trace_groups is not None:
        index, groups = trace_groups
        counts = torch.bincount(index, minlength=groups).float()
        trace = torch.zeros(groups, iterations, device=x.device)
    for i in range(iterations):
        if trace is not None:
            err = (base.project(x + t_cur, k) - px[..., :2]).abs().mean((1, 2))
            trace[:, i] = torch.zeros(trace.shape[0], device=x.device).index_add_(
                0, index, err) / counts
        if i >= fixed_steps:
            bx = x[..., 0] - x[..., 2] * rx
            by = x[..., 1] - x[..., 2] * ry
            atb = torch.stack([-(w * bx).sum(-1), -(w * by).sum(-1),
                               (w * (rx * bx + ry * by)).sum(-1)], -1)
            t = torch.einsum("rij,rj->ri", ata_inv, atb)
            t_cur = torch.where(t[:, 2:] < 0, -t, t)[:, None]
        y = x + t_cur
        x = x + (y * unit).sum(-1, keepdim=True) * unit - y
        out = control_mlp(base, p, cfg, x.reshape(r, -1), times[i:i + 1] * base.LABEL_SCALE,
                          precision)
        x = x + c1[i] * x - c2[i] * out.reshape(r, j, 3)
    return x, t_cur, trace


def solve_rows(base, p, cfg: dict, pipeline: dict, cluster, px, k, conf, group_rows: int,
               precision: str = "f32", trace_groups=None):
    """`base.solve_rows` of ZeDO-i (pipeline["init"] "rays") with the adapter:
    R rows of cluster [R, j, 3], px [R, j, 2], k [R, 3, 3], conf [R, j] or
    None. Returns (poses [R, j, 3], translations [R, 1, 3], trace or None)."""
    if pipeline["init"] != "rays":
        raise ValueError("the adapter is ZeDO-i's: its solve starts from the rays")
    with base.precision_context(precision):
        zedo, mode = pipeline["zedo"], pipeline["pelvis"]
        t0 = base.pelvis_translation(px[..., :2], k, zedo["IPO_T"], mode)
        rot, t = base.ipo(cluster, px, k, t0, zedo, group_rows)
        ray = base.rays(px[..., :2], k)
        ray = ray / torch.linalg.vector_norm(base.pelvis(ray, mode), dim=-1, keepdim=True)
        ray = ray * torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        x0 = torch.einsum("rij,rnj->rni", rot, ray - base.pelvis(ray, mode))
        iterations = zedo["OIL_iterations"]
        fixed = pipeline["refine_t_from"] * iterations // 1000
        return oil(base, p, cfg, {**pipeline["sde"], "eps": zedo["sampling_eps"]}, x0, t, px,
                   k, conf, iterations, fixed, precision, trace_groups)
