"""Fused forward of ZeDO-i's ControlNet adapter (models/control_mlp.py) for
the OIL hot loop: kernel #3 and its plain version.

The kernel is `csrc/score_mlp_control.cu`, kernel #1's wgmma layer
(`csrc/score_mlp.cuh`) under its own names, `control_layer` and
`control_input_bf16`; its header says what the checked-in dataflow lets it
fold. Here:

- `pack_weights`: the adapter's params -> bf16 input-major weights, each
  pre-centred by (I - P) as kernel #1's are, with the bridges folded in:
  layer 0 is [pre_dense + zc_layer_2 pre_dense_copy | pre_dense_copy]
  (N = 2H, both streams), each block's first layer is [b_dense1;
  zc_b_1 b_dense1_copy] against [h | c] (K = 2H), its second b_dense2.
  The products of weights are taken in f32 and rounded once.
- `step_vectors`: the [steps, 6, H] f32 per-step vectors (trunk pre, copy
  pre, then each block's two layers): the time projections of both streams,
  the solve's constant SiLU(zc_layer_1(infant_cond)) through pre_dense_copy,
  the bridges of the pre-activations' constant parts, and what depends on t
  alone after the checked-in overwrite `c = b_dense2_t_copy(temb)`:
  zc_b_2 of it into the block's second layer, SiLU(GN(b_gnorm2_copy, it))
  added to the copy that later blocks read (through zc_b_1 b_dense1_copy).
  The outputs the checked-in code discards (b_dense2_copy(c), and
  SiLU(GN(b_gnorm1_copy)), which the overwrite replaces) are not computed.

`fused_control_forward` launches the kernel for CUDA tensors and takes the
plain version (`fused_control_forward_reference`: the same packed operands,
kernel #1's `dense` and `_gn_silu`) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from zedo_tpu_torch.models import nn
from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.ops.kernels import score_kernel as sk
from zedo_tpu_torch.utils import compiled

LANE = sk.LANE
# GroupNorm layers by row of the per-step vectors
GN_NAMES = ("pre_gnorm", "pre_gnorm_copy", "b1_gnorm1", "b1_gnorm2", "b2_gnorm1", "b2_gnorm2")

# forwards of the CUDA kernel; one a forward, counted on each replay of a
# CUDA graph that holds it (utils/compiled.py)
launch_counts = {"fused_control_forward": 0}
compiled.register_counters(launch_counts)


def reset_launch_counts() -> None:
    launch_counts["fused_control_forward"] = 0


class PackedControlWeights(NamedTuple):
    """[K, N]-layout (input-major) weights, padded to lane multiples."""

    w_pre: torch.Tensor  # [io_pad, 2H]: trunk | copy
    w_d1: tuple  # 2x [2H, H]: [b_dense1; zc_b_1 b_dense1_copy]
    w_d2: tuple  # 2x [H, H]: b_dense2
    w_post: torch.Tensor  # [H, io_pad]
    bias_post: torch.Tensor  # [io_pad]
    gn_scale: torch.Tensor  # [6, H] f32
    gn_bias: torch.Tensor  # [6, H] f32
    ind: torch.Tensor  # [H, LANE] group indicator / group size (plain version)
    bcast_scaled: torch.Tensor  # [6, LANE, H] GN scale at group-member positions
    group_size: int


def kernel_supports(cfg) -> bool:
    """Architectures kernel #3 takes: 2 blocks at a width whose column tile
    is 128 with a power-of-two group (kernel #1's wgmma rule)."""
    return (cfg.n_blocks == 2 and cfg.hidden_dim % LANE == 0
            and sk.kernel_path(cfg.hidden_dim, cfg.hidden_dim // cfg.group_norm_groups) == "wgmma")


def _f32(params: dict) -> dict:
    return nn.tree_map(lambda a: a.to(torch.float32), params)


def pack_weights(params: dict, cfg, dtype=torch.bfloat16, gn_dtype=None) -> PackedControlWeights:
    """The adapter's params (torch [out, in] layout) -> the kernel's layout,
    on the params' device; gn_dtype is the GroupNorm statistics dtype
    (defaults to `dtype`)."""
    gn_dtype = gn_dtype or dtype
    if cfg.n_blocks != 2:
        raise ValueError("the fused control kernel specializes the shipped 2-block config")
    p = _f32(params)
    h, io = cfg.hidden_dim, cfg.n_joints * cfg.joint_dim
    io_pad = math.ceil(io / LANE) * LANE
    size = h // cfg.group_norm_groups
    dev = p["post_dense"]["weight"].device
    center, ind, bcast = sk.group_matrices(h, size, dev)

    def w(name):
        return p[name]["weight"]

    trunk_pre = w("pre_dense") + w("zc_layer_2") @ w("pre_dense_copy")
    w_pre = torch.cat([trunk_pre.T @ center, w("pre_dense_copy").T @ center], 1)
    w_pre = torch.nn.functional.pad(w_pre, (0, 0, 0, io_pad - io))
    w_d1 = tuple(torch.cat([w(f"b{b}_dense1").T, (w(f"zc_b{b}_1") @ w(f"b{b}_dense1_copy")).T])
                 @ center for b in (1, 2))
    w_d2 = tuple(w(f"b{b}_dense2").T @ center for b in (1, 2))
    w_post = torch.nn.functional.pad(w("post_dense").T, (0, io_pad - io))
    bias_post = torch.nn.functional.pad(p["post_dense"]["bias"], (0, io_pad - io))

    gn_scale = torch.stack([p[k]["weight"] for k in GN_NAMES])
    gn_bias = torch.stack([p[k]["bias"] for k in GN_NAMES])
    bcast_scaled = bcast[None] * gn_scale[:, None, :]

    def as_dt(a):
        return a.to(dtype).contiguous()

    return PackedControlWeights(
        w_pre=as_dt(w_pre), w_d1=tuple(as_dt(a) for a in w_d1),
        w_d2=tuple(as_dt(a) for a in w_d2), w_post=as_dt(w_post),
        bias_post=bias_post.contiguous(), gn_scale=gn_scale.contiguous(),
        gn_bias=gn_bias.contiguous(), ind=ind.to(gn_dtype),
        bcast_scaled=bcast_scaled.to(gn_dtype), group_size=size)


def step_vectors(params: dict, cfg, temb: torch.Tensor) -> torch.Tensor:
    """[..., 6, H] f32 per-step vectors of the packed forward at the shared
    time embeddings temb [E] or [steps, E] (the module docstring), centred
    as the packed weights are."""
    p = _f32(params)
    temb = temb.to(torch.float32)
    g = cfg.group_norm_groups

    def lin(name, a):
        return nn.linear(p[name], a)

    seed = nn.silu(lin("zc_layer_1", p["infant_cond"]))
    # the copy's pre-activation less its product with x
    c_pre = lin("pre_dense_copy", seed) + lin("pre_dense_t_copy", temb)
    rows = [p["pre_dense"]["bias"] + lin("pre_dense_t", temb) + lin("zc_layer_2", c_pre), c_pre]
    shift = torch.zeros_like(c_pre)  # the copy entering a block, less the pre-layer's
    for b in range(1, cfg.n_blocks + 1):
        c_d1 = lin(f"b{b}_dense1_copy", shift) + lin(f"b{b}_dense1_t_copy", temb)
        rows.append(p[f"b{b}_dense1"]["bias"] + lin(f"b{b}_dense1_t", temb)
                    + lin(f"zc_b{b}_1", c_d1))
        c_t = lin(f"b{b}_dense2_t_copy", temb)  # the checked-in overwrite
        rows.append(p[f"b{b}_dense2"]["bias"] + lin(f"b{b}_dense2_t", temb)
                    + lin(f"zc_b{b}_2", c_t))
        shift = shift + nn.silu(nn.group_norm(p[f"b{b}_gnorm2_copy"], c_t, g))
    center = sk.group_matrices(cfg.hidden_dim, cfg.hidden_dim // g, temb.device)[0]
    return torch.stack(rows, -2) @ center


def fused_control_forward_reference(x: torch.Tensor, packed: PackedControlWeights,
                                    vecs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel #3: x [B, C] f32 -> [B, C] f32, every
    product on operands rounded to the packed weight dtype, accumulated in
    f32, GroupNorm as kernel #1's plain version takes it."""
    b, c = x.shape
    io_pad, h2 = packed.w_pre.shape
    h = h2 // 2
    a = torch.nn.functional.pad(x.float(), (0, io_pad - c))
    z = sk.dense(a, packed.w_pre, vecs[0:2].reshape(-1))
    trunk, copy = sk.gn(z[:, :h], packed, 0), sk.gn(z[:, h:], packed, 1)
    for blk in range(2):
        l1, l2 = 2 + 2 * blk, 3 + 2 * blk
        h1 = sk.gn(sk.dense(torch.cat([trunk, copy], 1), packed.w_d1[blk], vecs[l1]), packed, l1)
        trunk = trunk + sk.gn(sk.dense(h1, packed.w_d2[blk], vecs[l2]), packed, l2)
    return sk.dense(trunk, packed.w_post, packed.bias_post)[:, :c]


LIBRARY = "score_mlp_control"  # its name in build.SOURCES
_lib = None


def load_library() -> ctypes.CDLL:
    """Kernel #3's library, built at first use. Raises when CUDA or nvcc is
    missing; there is no fallback."""
    global _lib
    if _lib is None:
        lib = build.load(LIBRARY)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zedo_control_forward.argtypes = [ptr] + [i32] * 7 + [ptr] * 16
        lib.zedo_control_takes.argtypes = [i32] * 3
        lib.zedo_control_padded_input.argtypes = [i32]
        lib.zedo_control_blocks_per_sm.argtypes = []
        for f in (lib.zedo_control_forward, lib.zedo_control_takes,
                  lib.zedo_control_padded_input, lib.zedo_control_blocks_per_sm):
            f.restype = i32
        _lib = lib
    return _lib


def check_operands(x: torch.Tensor, packed: PackedControlWeights, vecs: torch.Tensor):
    """Device, dtype, shape and contiguity of a kernel call's operands."""
    dev = x.device
    io_pad, h2 = packed.w_pre.shape
    h = h2 // 2
    if x.dim() != 2 or not 0 < x.shape[1] <= io_pad:
        raise ValueError(f"x: want [B, C <= {io_pad}], got {tuple(x.shape)}")
    bf = torch.bfloat16
    sk._check("x", x, torch.float32, tuple(x.shape), dev)
    sk._check("w_pre", packed.w_pre, bf, (io_pad, 2 * h), dev)
    for i in range(2):
        sk._check(f"w_d1[{i}]", packed.w_d1[i], bf, (2 * h, h), dev)
        sk._check(f"w_d2[{i}]", packed.w_d2[i], bf, (h, h), dev)
    sk._check("w_post", packed.w_post, bf, (h, io_pad), dev)
    for name in ("gn_scale", "gn_bias"):
        sk._check(name, getattr(packed, name), torch.float32, (6, h), dev)
    sk._check("vecs", vecs, torch.float32, (6, h), dev)
    sk._check("bias_post", packed.bias_post, torch.float32, (io_pad,), dev)


def fused_control_forward(x: torch.Tensor, packed: PackedControlWeights,
                          vecs: torch.Tensor) -> torch.Tensor:
    """One fused control forward: x [B, C] f32 (C <= io_pad) -> [B, C] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return fused_control_forward_reference(x, packed, vecs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_control_forward: unsupported device {x.device}")
    lib = load_library()
    check_operands(x, packed, vecs)
    mode = sk.gn_bf16(packed)
    io_pad, h2 = packed.w_pre.shape
    h = h2 // 2
    tile = sk.column_tile(h, packed.group_size)
    if not lib.zedo_control_takes(h, packed.group_size, tile):
        raise ValueError(f"hidden {h} with GroupNorm groups of {packed.group_size}: kernel #3 "
                         f"takes kernel #1's wgmma widths only (kernel_supports)")
    b, c = x.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    # scratch of this forward (from a CUDA graph's pool under capture)
    resid = torch.empty((b, h), dtype=torch.float32, device=x.device)
    act_hc = torch.empty((b, 2 * h), dtype=torch.bfloat16, device=x.device)
    act_h1 = torch.empty((b, h), dtype=torch.bfloat16, device=x.device)
    x_pad = torch.empty((b, lib.zedo_control_padded_input(c)), dtype=torch.bfloat16,
                        device=x.device)
    err = lib.zedo_control_forward(
        x.data_ptr(), b, c, io_pad, h, packed.group_size, tile, int(mode),
        packed.w_pre.data_ptr(), packed.w_d1[0].data_ptr(), packed.w_d2[0].data_ptr(),
        packed.w_d1[1].data_ptr(), packed.w_d2[1].data_ptr(), packed.w_post.data_ptr(),
        vecs.data_ptr(), packed.gn_scale.data_ptr(), packed.gn_bias.data_ptr(),
        packed.bias_post.data_ptr(), out.data_ptr(), resid.data_ptr(), act_hc.data_ptr(),
        act_h1.data_ptr(), x_pad.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"control kernel launch failed: CUDA error {err}")
    launch_counts["fused_control_forward"] += 1
    return out
