"""Plain PyTorch reference of ZeDO's solve, its evaluation, serving's ranking
and the prior's train step, written from the published description
(ZeDO, arXiv:2307.03833; ZeDO-i, WACVW 2024; score SDEs, Song et al. 2021).

It imports torch and numpy alone. The score network (ScoreModelFC_Adv) runs
in float32 with TF32 off unless a control precision is asked for:

    h  = GN(pre_dense(x) + pre_dense_t(temb)); SiLU        (dropout in training)
    2 x  h1 = SiLU(GN(dense1(h)  + dense1_t(temb)))
         h2 = SiLU(GN(dense2(h1) + dense2_t(temb)));  h = h + h2
    out = post_dense(h)
    temb = SiLU(Linear(sinusoid(t * 999)))

`precision` names how the products round their operands: "f32" (none),
"fp8" (both operands scaled per tensor to e4m3's range and rounded, the
products of a float8 path) or "tf32" (TF32 tensor cores on).

The solve follows one row (one pose under one hypothesis) at a time, batched:
a row's result depends on the other rows only through IPO's loss, the mean
over its hypothesis's rows, whose gradient with respect to the row's own
parameters is the row's own term over that count (`group_rows`). So any
sample of rows can be recomputed alone.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

GN_EPS = 1e-5
LABEL_SCALE = 999.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
E4M3_MAX = 448.0


@contextlib.contextmanager
def precision_context(precision: str):
    """TF32 on only for the "tf32" control; off for everything else."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _fp8(a: torch.Tensor) -> torch.Tensor:
    """a rounded to e4m3 after scaling its largest magnitude to 448."""
    scale = E4M3_MAX / a.detach().abs().amax().clamp(min=1e-30)
    return (a * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def linear(p: dict, name: str, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """x @ W^T + b with W [out, in], b [out]."""
    w = p[f"{name}.weight"]
    if precision == "fp8":
        return _fp8(x) @ _fp8(w).T + p[f"{name}.bias"]
    return x @ w.T + p[f"{name}.bias"]


def sinusoid(labels: torch.Tensor, dim: int) -> torch.Tensor:
    """Positional embedding of labels [T] -> [T, dim] (DDPM's)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=labels.device)
                      * -(math.log(10000.0) / (half - 1)))
    emb = labels.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


def score_mlp(p: dict, cfg: dict, x: torch.Tensor, labels: torch.Tensor,
              precision: str = "f32", dropout: float = 0.0, generator=None) -> torch.Tensor:
    """The network on x [B, C] at labels [B] or [1] (one label shared by all
    rows: its embedding is taken once). dropout > 0 draws each keep mask
    U[0, 1) < 1 - dropout from `generator`, after each SiLU in order."""
    groups = cfg["group_norm_groups"]
    temb = torch.nn.functional.silu(
        linear(p, "shared_time_embed.0", sinusoid(labels, cfg["embed_dim"]), precision))

    def drop(h):
        if dropout == 0.0:
            return h
        keep = 1.0 - dropout
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), device=h.device))

    def layer(name, a):
        h = linear(p, name, a, precision) + linear(p, f"{name}_t", temb, precision)
        gn = name.replace("dense", "gnorm")
        h = torch.nn.functional.group_norm(h, groups, p[f"{gn}.weight"], p[f"{gn}.bias"],
                                           GN_EPS)
        return drop(torch.nn.functional.silu(h))

    h = layer("pre_dense", x)
    for b in range(1, cfg["n_blocks"] + 1):
        h1 = layer(f"b{b}_dense1", h)
        h = h + layer(f"b{b}_dense2", h1)
    return linear(p, "post_dense", h, precision)


# --- geometry -------------------------------------------------------------

def homogeneous(px: torch.Tensor) -> torch.Tensor:
    return torch.cat([px, torch.ones_like(px[..., :1])], dim=-1)


def rays(px: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K^-1 [u, v, 1] of [R, j, 2] pixels, [R, 3, 3] intrinsics: [R, j, 3]."""
    return torch.einsum("rij,rnj->rni", torch.linalg.inv(k), homogeneous(px))


def project(points: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("rij,rnj->rni", k, points)
    return q[..., :2] / q[..., 2:]


def quaternion_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation of the (not normalised) quaternion [R, 4] (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    return torch.stack([
        1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
        s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
        s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def pelvis(v: torch.Tensor, mode: str) -> torch.Tensor:
    """[R, 1, c]: joint 0, or the mean of joints 0 and 3."""
    return v[:, 0:1] if mode == "joint0" else (v[:, 0:1] + v[:, 3:4]) / 2


def pelvis_translation(px, k, t_norm: float, mode: str) -> torch.Tensor:
    """The pelvis ray scaled to length t_norm: [R, 1, 3]."""
    ray = rays(pelvis(px, mode), k)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True) * t_norm


# --- IPO ------------------------------------------------------------------

def ipo(pose0, px, k, t0, zedo: dict, group_rows: int):
    """Adam (optax's form: eps after the bias-corrected root) on a rotation
    quaternion over RotAxes and a translation scale, minimising the mean L1
    reprojection error of the IPO_keylist joints over each hypothesis's
    `group_rows` rows. Returns (rotation [R, 3, 3], translation [R, 1, 3])."""
    r = pose0.shape[0]
    keys = torch.as_tensor(zedo["IPO_keylist"], device=pose0.device)
    pose, target = pose0[:, keys], px[:, keys, :2]
    weight = 1.0 / (group_rows * len(zedo["IPO_keylist"]) * 2)
    axes = zedo["RotAxes"]
    params = {"w": torch.ones(r, 1, device=pose0.device),
              "scale": torch.ones(r, 1, 1, device=pose0.device)}
    for a in axes:
        params[a] = torch.zeros(r, 1, device=pose0.device)
    lo, hi = zedo["IPO_minScaleT"], zedo["IPO_maxScaleT"]
    zero = torch.zeros(r, 1, device=pose0.device)

    def quaternion(ps):
        return torch.cat([ps["w"]] + [ps.get(a, zero) for a in "xyz"], -1)

    mu = {n: torch.zeros_like(v) for n, v in params.items()}
    nu = {n: torch.zeros_like(v) for n, v in params.items()}
    for step in range(1, zedo["IPO_iterations"] + 1):
        with torch.enable_grad():
            leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
            rot = quaternion_matrix(quaternion(leaves))
            x = torch.einsum("rij,rnj->rni", rot, pose) + t0 * leaves["scale"].clamp(lo, hi)
            loss = weight * (project(x, k) - target).abs().sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        c1, c2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
        for (n, v), g in zip(params.items(), grads):
            mu[n] = ADAM_B1 * mu[n] + (1 - ADAM_B1) * g
            nu[n] = ADAM_B2 * nu[n] + (1 - ADAM_B2) * g * g
            params[n] = v - zedo["IPO_lr"] * (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + ADAM_EPS)
    rot = quaternion_matrix(quaternion(params))
    return rot, t0 * params["scale"].clamp(lo, hi)


# --- OIL ------------------------------------------------------------------

def step_coefficients(sde: dict, iterations: int, device) -> tuple:
    """(times, c1, c2) of the probability-flow Euler step of the sub-VP SDE
    from T to eps in `iterations` steps of dt = 1 / iterations:
    x' = x + c1 x - c2 model(x), c1 = beta / 2N, c2 = g^2 / (std N), with
    std = 1 - exp(2 log_mean_coeff) (not square-rooted, as trained)."""
    t = torch.linspace(sde["T"], sde["eps"], iterations, dtype=torch.float32, device=device)
    b0, b1 = sde["beta_min"], sde["beta_max"]
    beta = b0 + t * (b1 - b0)
    g2 = beta * (1.0 - torch.exp(-2.0 * b0 * t - (b1 - b0) * t ** 2))
    std = 1.0 - torch.exp(2.0 * (-0.25 * t ** 2 * (b1 - b0) - 0.5 * t * b0))
    return t, 0.5 * beta / iterations, g2 / std / iterations


def oil(p, cfg, sde, x, t_cur, px, k, conf, iterations: int, fixed_steps: int,
        precision: str = "f32", trace_groups=None):
    """The camera-ray steps with one reverse-diffusion step each. From step
    `fixed_steps` on the translation is re-solved every step by weighted
    least squares (weights conf^4, or 1) and z-flipped to face the camera;
    each step moves every joint to the foot of its perpendicular on its
    ray, then takes the Euler step. trace_groups: (group index [R], groups)
    to record each step's mean pixel reprojection error per group at the
    step's entry. Returns (pose, translation, trace [groups, steps] or None)."""
    r, j, _ = x.shape
    ray = rays(px[..., :2], k)
    ray = ray / ray[..., 2:]
    unit = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    rx, ry = ray[..., 0], ray[..., 1]
    w = torch.ones_like(rx) if conf is None else conf.clamp(1e-4, 1.0) ** 4
    sw, swrx, swry = w.sum(-1), (w * rx).sum(-1), (w * ry).sum(-1)
    swr2 = (w * (rx * rx + ry * ry)).sum(-1)
    zero = torch.zeros_like(sw)
    ata = torch.stack([sw, zero, -swrx, zero, sw, -swry, -swrx, -swry, swr2], -1)
    ata_inv = torch.linalg.inv(ata.reshape(r, 3, 3))
    times, c1, c2 = step_coefficients(sde, iterations, x.device)
    trace = None
    if trace_groups is not None:
        index, groups = trace_groups
        counts = torch.bincount(index, minlength=groups).float()
        trace = torch.zeros(groups, iterations, device=x.device)
    for i in range(iterations):
        if trace is not None:
            err = (project(x + t_cur, k) - px[..., :2]).abs().mean((1, 2))
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
        out = score_mlp(p, cfg, x.reshape(r, -1), times[i:i + 1] * LABEL_SCALE, precision)
        x = x + c1[i] * x - c2[i] * out.reshape(r, j, 3)
    return x, t_cur, trace


def solve_rows(p, cfg: dict, pipeline: dict, cluster, px, k, conf, group_rows: int,
               precision: str = "f32", trace_groups=None):
    """The zero-shot solve of R rows: cluster [R, j, 3] (each row's
    hypothesis), px [R, j, 2], k [R, 3, 3], conf [R, j] or None.
    pipeline: {"zedo": the ZeDO block, "sde": ..., "pelvis": "joint0" |
    "mean03", "init": "cluster" (the adult solve) | "rays" (ZeDO-i),
    "refine_t_from": the step of 1000 from which T is re-solved}.
    Returns (poses [R, j, 3], translations [R, 1, 3], trace or None)."""
    with precision_context(precision):
        zedo, mode = pipeline["zedo"], pipeline["pelvis"]
        t0 = pelvis_translation(px[..., :2], k, zedo["IPO_T"], mode)
        if pipeline["init"] == "cluster":
            pose0 = cluster - cluster[:, 0:1]
            rot, t = ipo(pose0, px, k, t0, zedo, group_rows)
            x0 = torch.einsum("rij,rnj->rni", rot, pose0)
        else:
            rot, t = ipo(cluster, px, k, t0, zedo, group_rows)
            ray = rays(px[..., :2], k)
            ray = ray / torch.linalg.vector_norm(pelvis(ray, mode), dim=-1, keepdim=True)
            ray = ray * torch.linalg.vector_norm(t, dim=-1, keepdim=True)
            x0 = torch.einsum("rij,rnj->rni", rot, ray - pelvis(ray, mode))
        iterations = zedo["OIL_iterations"]
        fixed = pipeline["refine_t_from"] * iterations // 1000
        return oil(p, cfg, {**pipeline["sde"], "eps": zedo["sampling_eps"]}, x0, t, px, k, conf,
                   iterations, fixed, precision, trace_groups)


# --- evaluation and ranking (float64, numpy) ------------------------------

def mpjpe(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Mean per-joint distance of [..., j, 3]."""
    return np.linalg.norm(pred - gt, axis=-1).mean(-1)


def procrustes_aligned(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred [..., j, 3] moved by the similarity transform (reflections
    allowed) that best fits it to gt."""
    mu_p, mu_g = pred.mean(-2, keepdims=True), gt.mean(-2, keepdims=True)
    p0, g0 = pred - mu_p, gt - mu_g
    n_p = np.sqrt((p0 ** 2).sum((-2, -1), keepdims=True))
    n_g = np.sqrt((g0 ** 2).sum((-2, -1), keepdims=True))
    p0, g0 = p0 / n_p, g0 / n_g
    u, s, vt = np.linalg.svd(np.swapaxes(g0, -1, -2) @ p0)
    rot = np.swapaxes(vt, -1, -2) @ np.swapaxes(u, -1, -2)
    scale = s.sum(-1)[..., None, None] * n_g / n_p
    return scale * (pred - mu_p) @ rot + mu_g


def sample_errors(preds: np.ndarray, gt: np.ndarray, protocol2: bool) -> np.ndarray:
    """[N] least error over hypotheses of each sample: preds [N, S, j, 3],
    gt [N, j, 3] (metres), protocol 2 after Procrustes alignment."""
    preds = preds.astype(np.float64)
    gt_b = np.broadcast_to(gt.astype(np.float64)[:, None], preds.shape)
    if protocol2:
        preds = procrustes_aligned(preds, gt_b)
    return mpjpe(preds, gt_b).min(1)



def reprojection_errors(poses: np.ndarray, trans: np.ndarray, px: np.ndarray,
                        k: np.ndarray) -> np.ndarray:
    """[N, S] mean |projection - keypoint| in pixels of poses [N, S, j, 3]
    placed at trans [N, S, 1, 3]."""
    cam = (poses + trans).astype(np.float64)
    q = np.einsum("nij,nsbj->nsbi", k.astype(np.float64), cam)
    return np.abs(q[..., :2] / q[..., 2:] - px[:, None, :, :2]).mean((2, 3))


# --- the train step ---------------------------------------------------------

def lr_at(optim: dict, step: int) -> float:
    """The learning rate of the step-th update (1-based): warm-up from the
    count before the update, so the first runs at 0."""
    warmup = optim["warmup"]
    return optim["lr"] * min((step - 1) / warmup, 1.0) if warmup > 0 else optim["lr"]


def train_steps(p: dict, cfg: dict, training: dict, optim: dict, ema_rate: float,
                batches, seeds, precision: str = "f32") -> dict:
    """The first len(batches) train steps from weights p (f32 leaves by
    name; `sigmas` never trains): denoising score matching on the sub-VP
    SDE with t ~ U(eps, T) then z ~ N(0, 1) and the dropout masks drawn from
    a CUDA or CPU generator seeded by each step's seed, the global gradient
    norm clipped, Adam (torch's form), the EMA with its warm-up. Returns the
    losses, the first step's clipped gradients, and the weights and EMA
    shadows after the last step."""
    names = [n for n in p if n != "sigmas"]
    params = {n: p[n].clone() for n in names}
    shadow = {n: p[n].clone() for n in names}
    mu = {n: torch.zeros_like(v) for n, v in params.items()}
    nu = {n: torch.zeros_like(v) for n, v in params.items()}
    b0, b1, T, eps = training["beta_min"], training["beta_max"], training["T"], 1e-5
    losses, first = [], None
    for step, (batch, seed) in enumerate(zip(batches, seeds), start=1):
        gen = torch.Generator(device=batch.device).manual_seed(int(seed))
        with torch.enable_grad(), precision_context(precision):
            leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
            b = batch.shape[0]
            t = torch.rand((b,), generator=gen, device=batch.device) * (T - eps) + eps
            z = torch.randn(batch.shape, generator=gen, device=batch.device)
            lmc = -0.25 * t ** 2 * (b1 - b0) - 0.5 * t * b0
            std = (1.0 - torch.exp(2.0 * lmc))[:, None, None]
            noisy = torch.exp(lmc)[:, None, None] * batch + std * z
            out = score_mlp(leaves, cfg, noisy.reshape(b, -1), t * LABEL_SCALE,
                            "f32" if precision == "tf32" else precision,
                            dropout=cfg["dropout"], generator=gen)
            score = -out.reshape(batch.shape) / std
            loss = ((score * std + z) ** 2).reshape(b, -1).mean(-1).mean()
            grads = dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        coef = min(1.0, optim["grad_clip"] / (float(norm) + 1e-6))
        grads = {n: g * coef for n, g in grads.items()}
        if first is None:
            first = grads
        lr = lr_at(optim, step)
        c1, c2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
        decay = min(ema_rate, (1.0 + step) / (10.0 + step))
        for n in names:
            mu[n] = ADAM_B1 * mu[n] + (1 - ADAM_B1) * grads[n]
            nu[n] = ADAM_B2 * nu[n] + (1 - ADAM_B2) * grads[n] ** 2
            params[n] = params[n] - (lr / c1) * mu[n] / (torch.sqrt(nu[n]) / math.sqrt(c2)
                                                          + ADAM_EPS)
            shadow[n] = shadow[n] - (1.0 - decay) * (shadow[n] - params[n])
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first, "params": params, "ema": shadow}
