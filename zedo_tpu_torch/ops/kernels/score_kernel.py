"""Fused ScoreMLP forward for the OIL hot loop: CUDA kernel and plain version.

Port of zedo_tpu/ops/pallas/score_kernel.py. The kernel itself is
`csrc/score_mlp.cu` (see its header for the design and what bounds it): a
bf16 tensor-core product whose epilogue applies GroupNorm, SiLU and the
residual add, launched once per dense layer. Widths whose column tile is
128 with a power-of-two GroupNorm group (the published 1024, 2048, 256) take
the Hopper design: wgmma fed by a TMA/mbarrier ring, GroupNorm in the
accumulator registers. The other lane-aligned widths (384, 768) take the
wmma kernel of the same source; `kernel_path` says which. The library is
built with `nvcc` for sm_90a at first use (`build.py`) and called through
ctypes on PyTorch's current stream.

Packing is the same as the TPU kernel's: dense weights in input-major
layout, pre-centred by (I - P) so GroupNorm only reduces the variance,
time dependence folded into per-step [5, H] vectors (`step_vectors`), the
51-wide pose padded to 128 columns in the weights. The GroupNorm statistics
run in the dtype `ind` was packed in (`pack_weights(gn_dtype=...)`), bf16
or f32, in the plain version and in the kernel alike.

`fused_score_forward` launches the kernel for CUDA tensors and takes the
plain version (`fused_score_forward_reference`, a transcription of the TPU
kernel's `_kernel` and `_gn_silu`) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.utils import compiled

LANE = 128
GN_EPS = 1e-5

# launches of the CUDA kernel, by wrapper, and of fused_score_forward by
# GroupNorm statistics mode, by kernel path and by the rows it was given;
# the wrapper adds one to each per forward (a forward is six layer launches
# in the C library). A forward captured in a CUDA graph (utils/compiled.py)
# is counted on each replay of the graph.
launch_counts = {"fused_score_forward": 0}
gn_mode_launches = {"bf16": 0, "f32": 0}
path_launches = {"wgmma": 0, "wmma": 0}
row_launches: dict = {}
compiled.register_counters(launch_counts, gn_mode_launches, path_launches, row_launches)


def reset_launch_counts() -> None:
    for counts in (launch_counts, gn_mode_launches, path_launches):
        for name in counts:
            counts[name] = 0
    row_launches.clear()


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


def group_matrices(h: int, size: int, device) -> tuple:
    """f32 on `device`: (I - P) [h, h], which subtracts each GroupNorm
    group's mean; the group indicator / group size [h, LANE]; the broadcast
    of a group's value to its members [LANE, h]. Groups of `size` channels."""
    proj = np.zeros((h, h), np.float32)
    ind = np.zeros((h, LANE), np.float32)
    bcast = np.zeros((LANE, h), np.float32)
    for i in range(h // size):
        members = slice(i * size, (i + 1) * size)
        proj[members, members] = 1.0 / size
        ind[members, i] = 1.0 / size
        bcast[i, members] = 1.0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (np.eye(h, dtype=np.float32) - proj, ind, bcast))


def pack_weights(params: dict, cfg, dtype=torch.bfloat16,
                 gn_dtype=None) -> PackedScoreWeights:
    """ScoreMLP params (torch [out, in] layout) -> the kernel's padded
    input-major layout, on the params' device. gn_dtype is the GroupNorm
    statistics dtype (defaults to `dtype`); the CUDA kernel takes bf16 and
    float32."""
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

    center, ind, bcast = group_matrices(h, size, dev)

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

    bcast_scaled = bcast[None] * gn_scale[:, None, :]

    def as_dt(a):
        return a.to(dtype).contiguous()

    return PackedScoreWeights(
        w_pre=as_dt(w_pre), w_b=tuple(as_dt(w) for w in w_b), w_post=as_dt(w_post),
        gn_bias=gn_bias.contiguous(), bias_post=bias_post.contiguous(),
        t_proj_w=as_dt(t_proj_w), t_proj_b=t_proj_b,
        ind=ind.to(gn_dtype),
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


def dense(a, w, vec):
    """One dense layer of the plain versions: the product on operands rounded
    to the weight dtype, accumulated in f32, plus the f32 step vector."""
    return a.to(w.dtype).float() @ w.float() + vec[None]


def gn(a, packed: PackedScoreWeights, layer: int, gn_silu=_gn_silu):
    """GroupNorm + SiLU of GroupNorm layer `layer` (0..4); `gn_silu` takes
    `_gn_silu`'s arguments (the probe variants replace it)."""
    return gn_silu(a, packed.ind, packed.bcast_scaled[layer], packed.gn_bias[layer][None])


def fused_score_forward_reference(x: torch.Tensor, packed: PackedScoreWeights,
                                  vecs: torch.Tensor, gn_silu=_gn_silu) -> torch.Tensor:
    """Plain PyTorch version of the fused forward: x [B, C] f32 (C <= io_pad,
    missing columns read as zero) -> [B, C] f32. Every product is taken on
    operands rounded to the packed weight dtype, accumulated in f32. Each
    GroupNorm layer's epilogue is `gn_silu` (the TPU kernel's `_gn_silu`
    unless a probe variant is given: score_kernel_probe)."""
    b, c = x.shape
    io_pad = packed.w_pre.shape[0]
    h = torch.nn.functional.pad(x.float(), (0, io_pad - c))
    h = gn(dense(h, packed.w_pre, vecs[0]), packed, 0, gn_silu)
    for blk in range(2):
        l1, l2 = 1 + 2 * blk, 2 + 2 * blk
        h1 = gn(dense(h, packed.w_b[2 * blk], vecs[l1]), packed, l1, gn_silu)
        h2 = gn(dense(h1, packed.w_b[2 * blk + 1], vecs[l2]), packed, l2, gn_silu)
        h = h + h2
    out = dense(h, packed.w_post, packed.bias_post)
    return out[:, :c]


LIBRARY = "score_mlp"  # its name in build.SOURCES
_lib = None


def load_library() -> ctypes.CDLL:
    """The kernel's library, built at first use. Raises when CUDA or nvcc is
    missing; there is no fallback."""
    global _lib
    if _lib is None:
        lib = build.load(LIBRARY)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zedo_score_mlp_forward.argtypes = [ptr] + [i32] * 7 + [ptr] * 16
        lib.zedo_score_mlp_product.argtypes = [ptr, i32, i32, ptr, i32, ptr, ptr, i32, ptr]
        lib.zedo_score_mlp_min_column_tile.argtypes = []
        lib.zedo_score_mlp_max_column_tile.argtypes = []
        lib.zedo_score_mlp_takes_wgmma.argtypes = [i32] * 3
        lib.zedo_score_mlp_padded_input.argtypes = [i32]
        lib.zedo_score_mlp_wgmma_blocks_per_sm.argtypes = []
        for f in (lib.zedo_score_mlp_forward, lib.zedo_score_mlp_product,
                  lib.zedo_score_mlp_wgmma_blocks_per_sm,
                  lib.zedo_score_mlp_min_column_tile, lib.zedo_score_mlp_max_column_tile,
                  lib.zedo_score_mlp_takes_wgmma, lib.zedo_score_mlp_padded_input):
            f.restype = i32
        _lib = lib
    return _lib


def column_tile(hidden: int, group: int) -> int:
    """Column tile of the kernel's hidden layers: a multiple of 16 and of
    the GroupNorm group size that divides `hidden`, the largest such up to
    128 (128 for groups of 4, 8, 16, 32, 64; 96 for 12 and 24; 80 for 20)
    or, for wider groups, the least common multiple itself (144 for 36)."""
    lcm = math.lcm(group, 16)
    tile = lcm * max(1, LANE // lcm)
    return tile if hidden % tile == 0 else lcm


WGMMA_GROUPS = (4, 8, 16, 32, 64)
WGMMA_STAGE_DEPTH = 64  # k-values of one pipeline stage of the wgmma kernel


def kernel_path(hidden: int, group: int) -> str:
    """Which kernel of the library a forward at this width takes: "wgmma"
    where the column tile is 128 with a power-of-two group of 4 to 64
    channels, else "wmma". Mirrors the rule of the C entry point
    (`zedo_score_mlp_takes_wgmma`), which decides; the card tests hold the
    two against each other."""
    wgmma = (hidden % LANE == 0 and column_tile(hidden, group) == LANE
             and group in WGMMA_GROUPS)
    return "wgmma" if wgmma else "wmma"


def padded_input_columns(c: int) -> int:
    """Columns of the bf16 copy of x that the wgmma path reads."""
    return math.ceil(c / WGMMA_STAGE_DEPTH) * WGMMA_STAGE_DEPTH


def kernel_supports(cfg) -> bool:
    """Architectures the CUDA kernel takes, JAX's Pallas contract: 2
    residual blocks and a lane-aligned hidden width. A width whose column
    tile the kernel was not built for raises in `fused_score_forward`."""
    return cfg.n_blocks == 2 and cfg.hidden_dim % LANE == 0


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def gn_bf16(packed: PackedScoreWeights) -> bool:
    """GroupNorm statistics mode of the packed weights, as the kernels take
    it: True for bf16, False for f32; anything else raises."""
    if packed.ind.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernels reduce GroupNorm statistics in bf16 or f32, "
                         f"not {packed.ind.dtype}")
    return packed.ind.dtype == torch.bfloat16


def check_operands(x: torch.Tensor, packed: PackedScoreWeights, vecs: torch.Tensor):
    """Device, dtype, shape and contiguity of a kernel call's operands."""
    dev = x.device
    io_pad, h = packed.w_pre.shape
    if x.dim() != 2 or not 0 < x.shape[1] <= io_pad:
        raise ValueError(f"x: want [B, C <= {io_pad}], got {tuple(x.shape)}")
    if len(packed.w_b) != 4:
        raise ValueError("the kernels specialize the shipped 2-block config")
    bf = torch.bfloat16
    _check("x", x, torch.float32, tuple(x.shape), dev)
    _check("w_pre", packed.w_pre, bf, (io_pad, h), dev)
    for i, w in enumerate(packed.w_b):
        _check(f"w_b[{i}]", w, bf, (h, h), dev)
    _check("w_post", packed.w_post, bf, (h, io_pad), dev)
    _check("vecs", vecs, torch.float32, (5, h), dev)
    _check("gn_scale", packed.gn_scale, torch.float32, (5, h), dev)
    _check("gn_bias", packed.gn_bias, torch.float32, (5, h), dev)
    _check("bias_post", packed.bias_post, torch.float32, (io_pad,), dev)


def wgmma_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] bf16 @ w [K, N] bf16 -> [M, N] f32 through the wgmma kernel's
    product and its bias epilogue (zero bias): the kernel's TMA ring,
    descriptors and accumulator layout alone, for checks against
    torch.matmul on the card. K a multiple of 64, N of 128."""
    lib = load_library()
    (m, k), n = a.shape, w.shape[1]
    _check("a", a, torch.bfloat16, (m, k), a.device)
    _check("w", w, torch.bfloat16, (k, n), a.device)
    if a.device.type != "cuda" or k % WGMMA_STAGE_DEPTH or n % LANE:
        raise ValueError(f"wgmma_product: want CUDA bf16 [M, K % 64 == 0] @ [K, N % 128 == 0], "
                         f"got {tuple(a.shape)} @ {tuple(w.shape)} on {a.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    bias = torch.zeros(n, dtype=torch.float32, device=a.device)
    err = lib.zedo_score_mlp_product(a.data_ptr(), m, k, w.data_ptr(), n, bias.data_ptr(),
                                     out.data_ptr(), n,
                                     torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma product launch failed: CUDA error {err}")
    return out


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
    check_operands(x, packed, vecs)
    mode = gn_bf16(packed)
    io_pad, h = packed.w_pre.shape
    tile = column_tile(h, packed.group_size)
    lo, hi = lib.zedo_score_mlp_min_column_tile(), lib.zedo_score_mlp_max_column_tile()
    if h % LANE or not lo <= tile <= hi:
        raise ValueError(
            f"hidden {h} with GroupNorm groups of {packed.group_size} needs a column tile "
            f"of {tile}; the kernel's column tiles span {lo} to {hi} columns (its "
            f"accumulators and staged epilogue tile must fit registers and shared memory)")
    b, c = x.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    wgmma = bool(lib.zedo_score_mlp_takes_wgmma(h, packed.group_size, tile))
    # scratch of this forward; under CUDA graph capture it comes from the
    # graph's pool and stays its own, and the tensor maps the library encodes
    # for it are kernel parameters passed by value, captured with the launch
    resid = torch.empty((b, h), dtype=torch.float32, device=x.device)
    act_h = torch.empty((b, h), dtype=torch.bfloat16, device=x.device)
    act_h1 = torch.empty((b, h), dtype=torch.bfloat16, device=x.device)
    x_pad = torch.empty((b, lib.zedo_score_mlp_padded_input(c) if wgmma else 0),
                        dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.zedo_score_mlp_forward(
        x.data_ptr(), b, c, io_pad, h, packed.group_size, tile, int(mode),
        packed.w_pre.data_ptr(), *(w.data_ptr() for w in packed.w_b),
        packed.w_post.data_ptr(), vecs.data_ptr(), packed.gn_scale.data_ptr(),
        packed.gn_bias.data_ptr(), packed.bias_post.data_ptr(), out.data_ptr(),
        resid.data_ptr(), act_h.data_ptr(), act_h1.data_ptr(), x_pad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"score kernel launch failed on the {'wgmma' if wgmma else 'wmma'} path: "
            f"CUDA error {err}")
    launch_counts["fused_score_forward"] += 1
    gn_mode_launches["bf16" if mode else "f32"] += 1
    path_launches["wgmma" if wgmma else "wmma"] += 1
    row_launches[b] = row_launches.get(b, 0) + 1
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
