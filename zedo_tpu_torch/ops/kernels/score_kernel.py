"""Fused ScoreMLP forward for the OIL hot loop: CUDA kernel and plain version.

Port of zedo_tpu/ops/pallas/score_kernel.py. The kernel itself is
`csrc/score_mlp.cu` (see its header for the design and what bounds it): one
templated bf16 tensor-core GEMM whose epilogue applies GroupNorm, SiLU and
the residual add, launched once per dense layer. It is built with `nvcc`
for sm_90a into a shared library with a plain C interface at first use,
under `build/zedo_tpu_torch/<source hash>/` beside the package, and called
through ctypes on PyTorch's current stream.

Packing is the same as the TPU kernel's: dense weights in input-major
layout, pre-centred by (I - P) so GroupNorm only reduces the variance,
time dependence folded into per-step [5, H] vectors (`step_vectors`), the
51-wide pose padded to 128 columns in the weights.

`fused_score_forward` launches the kernel for CUDA tensors and takes the
plain version (`fused_score_forward_reference`, a transcription of the TPU
kernel's `_kernel` and `_gn_silu`) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

LANE = 128
GN_EPS = 1e-5

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_SOURCES = ("score_mlp.cu",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "zedo_tpu_torch"

# launches of the CUDA kernel, by wrapper; the wrappers add one per launch
launch_counts = {"fused_score_forward": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class PackedScoreWeights(NamedTuple):
    """[K, N]-layout (input-major) weight matrices, padded to lane multiples."""

    w_pre: torch.Tensor  # [io_pad, H]
    w_b: tuple  # 4x [H, H]: (b1_d1, b1_d2, b2_d1, b2_d2)
    w_post: torch.Tensor  # [H, io_pad]
    gn_bias: torch.Tensor  # [5, H]
    bias_post: torch.Tensor  # [io_pad]
    t_proj_w: torch.Tensor  # [5, E, H] time-projection weights
    t_proj_b: torch.Tensor  # [5, H] dense biases folded into the step vectors
    ind: torch.Tensor  # [H, LANE] group indicator (G columns used) / group size
    bcast_scaled: torch.Tensor  # [5, LANE, H] GN scale at group-member positions
    gn_scale: torch.Tensor  # [5, H] f32 GN scale (the CUDA epilogue reads it)
    group_size: int  # channels per GroupNorm group


def pack_weights(params: dict, cfg, dtype=torch.bfloat16,
                 gn_dtype=None) -> PackedScoreWeights:
    """ScoreMLP params (torch [out, in] layout) -> the kernel's padded
    input-major layout, on the params' device. gn_dtype is the GroupNorm
    statistics dtype of the plain version (defaults to `dtype`); the CUDA
    kernel reduces in f32 and takes only gn_dtype=float32."""
    gn_dtype = gn_dtype or dtype
    if cfg.n_blocks != 2:
        raise ValueError("the fused kernel specializes the shipped 2-block config")
    h = cfg.hidden_dim
    io = cfg.n_joints * cfg.joint_dim
    io_pad = math.ceil(io / LANE) * LANE
    g = cfg.group_norm_groups
    size = h // g
    dev = params["post_dense"]["weight"].device

    def w32(p):
        return p.to(torch.float32)

    proj = np.zeros((h, h), np.float32)
    for i in range(g):
        proj[i * size:(i + 1) * size, i * size:(i + 1) * size] = 1.0 / size
    center = torch.as_tensor(np.eye(h, dtype=np.float32) - proj, device=dev)

    def pad2(x, rows, cols):
        return torch.nn.functional.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))

    w_pre = pad2(w32(params["pre_dense"]["weight"]).T @ center, io_pad, h)
    w_b = tuple(w32(params[k]["weight"]).T @ center
                for k in ("b1_dense1", "b1_dense2", "b2_dense1", "b2_dense2"))
    w_post = pad2(w32(params["post_dense"]["weight"]).T, h, io_pad)
    bias_post = torch.nn.functional.pad(w32(params["post_dense"]["bias"]), (0, io_pad - io))

    gn_names = ["pre_gnorm", "b1_gnorm1", "b1_gnorm2", "b2_gnorm1", "b2_gnorm2"]
    gn_scale = torch.stack([w32(params[k]["weight"]) for k in gn_names])
    gn_bias = torch.stack([w32(params[k]["bias"]) for k in gn_names])

    tp_names = ["pre_dense_t", "b1_dense1_t", "b1_dense2_t", "b2_dense1_t", "b2_dense2_t"]
    t_proj_w = torch.stack([w32(params[k]["weight"]).T @ center for k in tp_names])
    dense_names = ["pre_dense", "b1_dense1", "b1_dense2", "b2_dense1", "b2_dense2"]
    t_proj_b = torch.stack(
        [(w32(params[k]["bias"]) + w32(params[kt]["bias"])) @ center
         for k, kt in zip(dense_names, tp_names)])

    ind = np.zeros((h, LANE), np.float32)
    bcast = np.zeros((LANE, h), np.float32)
    for i in range(g):
        ind[i * size:(i + 1) * size, i] = 1.0 / size
        bcast[i, i * size:(i + 1) * size] = 1.0
    bcast_scaled = torch.as_tensor(bcast, device=dev)[None] * gn_scale[:, None, :]

    def as_dt(a):
        return a.to(dtype).contiguous()

    return PackedScoreWeights(
        w_pre=as_dt(w_pre), w_b=tuple(as_dt(w) for w in w_b), w_post=as_dt(w_post),
        gn_bias=gn_bias.contiguous(), bias_post=bias_post.contiguous(),
        t_proj_w=as_dt(t_proj_w), t_proj_b=t_proj_b,
        ind=torch.as_tensor(ind, device=dev).to(gn_dtype),
        bcast_scaled=bcast_scaled.to(gn_dtype),
        gn_scale=gn_scale.contiguous(), group_size=size,
    )


def step_vectors(packed: PackedScoreWeights, temb: torch.Tensor) -> torch.Tensor:
    """[..., 5, H] f32 per-step bias vectors: dense_bias + t_bias + temb @ Wt.
    temb: [E] or [steps, E] shared time embeddings."""
    tw = packed.t_proj_w
    proj = torch.einsum("...e,leh->...lh", temb.to(tw.dtype).float(), tw.float())
    return proj + packed.t_proj_b


def _gn_silu(centered, ind, bcast_scaled, bias):
    """GroupNorm + SiLU of group-mean-free f32 rows (the TPU kernel's
    `_gn_silu`): the stats and broadcast products run on operands rounded to
    the packed GN dtype, accumulated in f32."""
    sq = centered * centered
    var_g = sq.to(ind.dtype).float() @ ind.float()
    rstd = torch.rsqrt(var_g + GN_EPS)
    rstd_scale_c = rstd.to(bcast_scaled.dtype).float() @ bcast_scaled.float()
    xn = centered * rstd_scale_c + bias
    return xn * (0.5 * torch.tanh(0.5 * xn) + 0.5)


def fused_score_forward_reference(x: torch.Tensor, packed: PackedScoreWeights,
                                  vecs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused forward: x [B, C] f32 (C <= io_pad,
    missing columns read as zero) -> [B, C] f32. Every product is taken on
    operands rounded to the packed weight dtype, accumulated in f32."""
    b, c = x.shape
    io_pad = packed.w_pre.shape[0]
    dt = packed.w_pre.dtype
    h = torch.nn.functional.pad(x.float(), (0, io_pad - c))

    def dense(a, w, row):
        return a.to(dt).float() @ w.float() + vecs[row][None]

    def gn(a, row):
        return _gn_silu(a, packed.ind, packed.bcast_scaled[row], packed.gn_bias[row][None])

    h = gn(dense(h, packed.w_pre, 0), 0)
    for blk in range(2):
        l1, l2 = 1 + 2 * blk, 2 + 2 * blk
        h1 = gn(dense(h, packed.w_b[2 * blk], l1), l1)
        h2 = gn(dense(h1, packed.w_b[2 * blk + 1], l2), l2)
        h = h + h2
    out = h.to(dt).float() @ packed.w_post.float() + packed.bias_post[None]
    return out[:, :c]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the score kernel is built with the CUDA "
                       "toolkit at first use (set CUDA_HOME)")


class _Library(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when the library was already built
    ptxas: str  # nvcc -Xptxas -v resource lines of this build


_library = None


def load_library() -> _Library:
    """Build (once per source hash) and load the kernel library. Raises
    when CUDA or nvcc is missing; there is no fallback."""
    global _library
    if _library is not None:
        return _library
    if not torch.cuda.is_available():
        raise RuntimeError("the fused score kernel needs a CUDA device")
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so = out_dir / "libzedo_score_mlp.so"
    build_seconds, ptxas = 0.0, ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libzedo_score_mlp.{os.getpid()}.so"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp)] + [str(_CSRC / n) for n in _SOURCES]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        ptxas = "\n".join(line for line in proc.stderr.splitlines()
                          if "registers" in line or "spill" in line)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.zedo_score_mlp_forward
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 15)
    fn.restype = ctypes.c_int
    lib.zedo_score_mlp_column_tile.argtypes = []
    lib.zedo_score_mlp_column_tile.restype = ctypes.c_int
    if lib.zedo_score_mlp_column_tile() != LANE:
        raise RuntimeError("the kernel's column tile differs from LANE; "
                           "_kernel_takes would admit widths it cannot run")
    _library = _Library(lib, str(so), build_seconds, ptxas)
    return _library


def _kernel_takes(hidden: int, group_size: int) -> bool:
    """Hidden width a multiple of the kernel's 128-column tile, GroupNorm
    groups of a power of two of at most 32 channels (a group never leaves a
    warp)."""
    return hidden % LANE == 0 and group_size <= 32 and group_size & (group_size - 1) == 0


def kernel_supports(cfg) -> bool:
    """Architectures the CUDA kernel takes: 2 residual blocks and a width
    `_kernel_takes`."""
    return cfg.n_blocks == 2 and _kernel_takes(cfg.hidden_dim,
                                               cfg.hidden_dim // cfg.group_norm_groups)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def fused_score_forward(x: torch.Tensor, packed: PackedScoreWeights,
                        vecs: torch.Tensor) -> torch.Tensor:
    """One fused forward: x [B, C] f32 (C <= io_pad) -> [B, C] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return fused_score_forward_reference(x, packed, vecs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_score_forward: unsupported device {x.device}")
    lib = load_library()
    dev = x.device
    io_pad, h = packed.w_pre.shape
    if x.dim() != 2 or not 0 < x.shape[1] <= io_pad:
        raise ValueError(f"x: want [B, C <= {io_pad}], got {tuple(x.shape)}")
    b, c = x.shape
    if not _kernel_takes(h, packed.group_size) or len(packed.w_b) != 4:
        raise ValueError(f"kernel does not take hidden {h} with GroupNorm groups of "
                         f"{packed.group_size}")
    if packed.ind.dtype != torch.float32:
        raise ValueError("the CUDA kernel reduces GroupNorm statistics in f32: pack "
                         "with gn_dtype=torch.float32")
    bf = torch.bfloat16
    _check("x", x, torch.float32, (b, c), dev)
    _check("w_pre", packed.w_pre, bf, (io_pad, h), dev)
    for i, w in enumerate(packed.w_b):
        _check(f"w_b[{i}]", w, bf, (h, h), dev)
    _check("w_post", packed.w_post, bf, (h, io_pad), dev)
    _check("vecs", vecs, torch.float32, (5, h), dev)
    _check("gn_scale", packed.gn_scale, torch.float32, (5, h), dev)
    _check("gn_bias", packed.gn_bias, torch.float32, (5, h), dev)
    _check("bias_post", packed.bias_post, torch.float32, (io_pad,), dev)

    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    resid = torch.empty((b, h), dtype=torch.float32, device=dev)
    act_h = torch.empty((b, h), dtype=bf, device=dev)
    act_h1 = torch.empty((b, h), dtype=bf, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lib.zedo_score_mlp_forward(
        x.data_ptr(), b, c, io_pad, h, packed.group_size,
        packed.w_pre.data_ptr(), *(w.data_ptr() for w in packed.w_b),
        packed.w_post.data_ptr(), vecs.data_ptr(), packed.gn_scale.data_ptr(),
        packed.gn_bias.data_ptr(), packed.bias_post.data_ptr(), out.data_ptr(),
        resid.data_ptr(), act_h.data_ptr(), act_h1.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"score kernel launch failed: CUDA error {err}")
    launch_counts["fused_score_forward"] += 1
    return out


def analytic_fwd_flops(batch_rows: int, cfg) -> int:
    """Analytic FLOPs of one fused score forward on `batch_rows` poses, the
    formula of the TPU kernel's cost estimate (the 10*h*LANE term counts the
    GroupNorms' two indicator products each)."""
    h = cfg.hidden_dim
    io = cfg.n_joints * cfg.joint_dim
    io_pad = math.ceil(io / LANE) * LANE
    n_gn = 1 + 2 * cfg.n_blocks
    return 2 * batch_rows * (
        2 * io_pad * h + 2 * cfg.n_blocks * h * h + 2 * n_gn * h * LANE)


def pad_rows(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Zero-pad the leading axis to a tile multiple."""
    b = x.shape[0]
    target = math.ceil(b / tile) * tile
    if target == b:
        return x
    pad = x.new_zeros((target - b,) + tuple(x.shape[1:]))
    return torch.cat([x, pad], 0)
