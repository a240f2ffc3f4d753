"""Split ScoreMLP forward: the whole forward in one launch, each row tile
run as two independent half-tile chains.

Port of tools/bench_kernel.py:108 `fwd_split` (body `_kernel_split`), the
TPU experiment that ran each row tile of the fused score kernel as two
half-tile chains so that one half's GroupNorm/SiLU overlaps the other
half's products. The kernel is `csrc/score_mlp_split.cu` (see its header
for the design and what bounds it): `wgmma` with the rows on N, one TMA
weight ring fed by four producer threads, two warpgroups that take the
channel tiles in turn (one's GroupNorm/SiLU under the other's products), a
layer's output held in registers, one instantiation per GroupNorm mode and
group size. It computes exactly the function of
`score_kernel.fused_score_forward` on the same `PackedScoreWeights`, in both
GroupNorm statistics modes.

`fused_score_forward_split` launches the kernel for CUDA tensors and takes
the plain version (`fused_score_forward_split_reference`) only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.ops.kernels import score_kernel as sk

# The block's shared-memory budget, mirrored from csrc/score_mlp_split.cu
# (the library decides; `load_library` holds the two against each other).
SMEM_LIMIT = 232448  # dynamic shared memory of an H100 block
TILE_BYTES = 8192  # a tile of the weight ring: [64 k, 64 channels] bf16
MIN_STAGES, MAX_STAGES = 4, 16  # tiles of the ring: at least, at most
TILE_ROWS = 56  # rows of a block: the N of the kernel's wgmma
MAX_HIDDEN = 1024  # a layer's output waits in registers: 16 channel tiles of 64
# Channels of a GroupNorm group the kernel reduces. With groups of 4 the
# function itself is ill-conditioned on large batches (some row has a group
# whose variance is near the epsilon, and 1 / sqrt(var + eps) multiplies every
# rounding difference of the layer's input): there the kernels and the plain
# version differ by what the order of an f32 sum moves the plain version
# itself, 5e-2 on 44,300 rows (chip_smoke.check_groups_of_4).
GROUPS = (4, 8, 16, 32, 64)

# launches of the CUDA kernel; the wrapper adds one per launch
launch_counts = {"fused_score_forward_split": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def smem_bytes(hidden: int, stages: int) -> int:
    """Shared memory of a block with a ring of `stages` tiles: alignment
    slack, the ring, one bf16 activation buffer (2 * hidden bytes a row), the
    warps' exchange of GroupNorm sums and the barriers."""
    return (1024 + stages * TILE_BYTES + 2 * hidden * TILE_ROWS + 64 * TILE_ROWS
            + 3 * MAX_STAGES * 8)


def tile_rows(hidden: int) -> int:
    """Rows of the kernel's block at this width, 0 for a width it does not
    take: 56 rows where the hidden width is a multiple of 64 up to 1024 (a
    layer's output waits in registers, 8 channel tiles of 64 a warpgroup) and
    the layer's input fits a block beside a ring of MIN_STAGES tiles. The
    forward needs a multiple of 128 (`check_width`); the product alone
    (`split_product`) takes every such width."""
    fits = smem_bytes(hidden, MIN_STAGES) <= SMEM_LIMIT
    return TILE_ROWS if hidden % 64 == 0 and hidden <= MAX_HIDDEN and fits else 0


def ring_stages(hidden: int) -> int:
    """Stages of the weight ring: what the block's shared memory has left."""
    return min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(hidden, 0)) // TILE_BYTES)


def check_width(hidden: int, group: int) -> int:
    """Rows of the kernel's block at this width; raises, naming the width and
    the rule, for a width or a GroupNorm group size the kernel does not
    take."""
    tile = tile_rows(hidden)
    if hidden % sk.LANE or group not in GROUPS or not tile:
        raise ValueError(
            f"the split kernel does not take hidden {hidden} with GroupNorm groups of "
            f"{group}: it needs hidden a multiple of {sk.LANE} up to {MAX_HIDDEN} (a layer's "
            f"output of {TILE_ROWS} rows waits in registers) and groups of {GROUPS} channels")
    return tile


def grid_blocks(rows: int, tile: int) -> int:
    """Blocks of a launch: the row tiles."""
    return math.ceil(rows / tile)


def swizzle128(offset: int) -> int:
    """Where the byte at `offset` of a tile of 128-byte rows lies under the
    128-byte swizzle, both counted from the tile's 1024-byte-aligned start
    (hopper.cuh `swizzle128`): the index of the 16-byte chunk is XORed with
    the row's index within its 1024-byte atom."""
    return offset ^ (((offset >> 7) & 7) << 4)


def fused_score_forward_split_reference(x: torch.Tensor, packed: sk.PackedScoreWeights,
                                        vecs: torch.Tensor,
                                        tile: int | None = None) -> torch.Tensor:
    """Plain version of the split forward, the TPU `_kernel_split` written
    out: the rows are cut into tiles of `tile` (the rows of the kernel's
    block by default), each tile into two halves, and the two halves run
    their chains side by side, layer by layer.
    x [B, C] f32 -> [B, C] f32, the function of the fused forward."""
    b, c = x.shape
    io_pad, hidden = packed.w_pre.shape
    tile = tile or TILE_ROWS
    half = tile // 2
    x_pad = sk.pad_rows(torch.nn.functional.pad(x.float(), (0, io_pad - c)), tile)
    tiles = x_pad.view(-1, 2, half, io_pad)
    hs = [tiles[:, i].reshape(-1, io_pad) for i in range(2)]
    hs = [sk.gn(sk.dense(h, packed.w_pre, vecs[0]), packed, 0) for h in hs]
    for blk in range(2):
        l1, l2 = 1 + 2 * blk, 2 + 2 * blk
        h1s = [sk.gn(sk.dense(h, packed.w_b[2 * blk], vecs[l1]), packed, l1) for h in hs]
        h2s = [sk.gn(sk.dense(h1, packed.w_b[2 * blk + 1], vecs[l2]), packed, l2)
               for h1 in h1s]
        hs = [h + h2 for h, h2 in zip(hs, h2s)]
    outs = [sk.dense(h, packed.w_post, packed.bias_post) for h in hs]
    out = torch.stack([o.view(-1, half, io_pad) for o in outs], 1).reshape(-1, io_pad)
    return out[:b, :c]


_lib = None


def load_library() -> ctypes.CDLL:
    """The kernel's library, built at first use. Raises when CUDA or nvcc is
    missing; there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load("score_mlp_split")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.zedo_score_mlp_split_forward.argtypes = (
        [ptr] + [i32] * 6 + [ptr] * 12 + [ctypes.c_longlong, ptr])
    lib.zedo_score_mlp_split_product.argtypes = [ptr, i32, i32, ptr, i32, ptr, ptr, ptr]
    lib.zedo_swizzle_check.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.zedo_score_mlp_split_tile_rows.argtypes = [i32]
    lib.zedo_score_mlp_split_smem_bytes.argtypes = [i32]
    lib.zedo_score_mlp_split_stages.argtypes = [i32]
    lib.zedo_score_mlp_split_smem_limit.argtypes = []
    for f in (lib.zedo_score_mlp_split_forward, lib.zedo_score_mlp_split_product,
              lib.zedo_swizzle_check, lib.zedo_score_mlp_split_tile_rows,
              lib.zedo_score_mlp_split_smem_bytes, lib.zedo_score_mlp_split_stages,
              lib.zedo_score_mlp_split_smem_limit):
        f.restype = i32
    for hidden in range(64, 2049, 64):
        if lib.zedo_score_mlp_split_tile_rows(hidden) != tile_rows(hidden):
            raise RuntimeError(f"the split kernel's row tile at hidden {hidden} differs "
                               f"from score_kernel_split.tile_rows")
    _lib = lib
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def split_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] bf16 @ w [K, N] bf16 -> [M, N] f32 through the split kernel's
    transposed product alone (weight tiles as the MN-major A operand from
    the TMA ring, the rows as B written through the swizzle function, the
    accumulator layout of the output layer), for checks against
    torch.matmul on the card. K and N multiples of 64 up to 1024."""
    lib = load_library()
    (m, k), n = a.shape, w.shape[1]
    sk._check("a", a, torch.bfloat16, (m, k), a.device)
    sk._check("w", w, torch.bfloat16, (k, n), a.device)
    if a.device.type != "cuda" or n % 64 or not tile_rows(k) or not tile_rows(n):
        raise ValueError(f"split_product: want CUDA bf16 [M, K] @ [K, N], K and N multiples of "
                         f"64 up to {MAX_HIDDEN}, got {tuple(a.shape)} @ {tuple(w.shape)} on "
                         f"{a.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    bias = torch.zeros(n, dtype=torch.float32, device=a.device)
    a32 = a.float()
    err = lib.zedo_score_mlp_split_product(a32.data_ptr(), m, k, w.data_ptr(), n,
                                           bias.data_ptr(), out.data_ptr(), _stream(a.device))
    if err != 0:
        raise RuntimeError(f"split product launch failed: CUDA error {err}")
    return out


def swizzle_images(src: torch.Tensor):
    """src [rows, 64] bf16 on the card (rows a multiple of 8 up to 128) ->
    two flat bf16 images of shared memory holding it under the 128-byte
    swizzle: as one TMA box lands it, and as the kernel's address function
    (`swizzle128`) places it. They must be equal."""
    lib = load_library()
    rows = src.shape[0]
    sk._check("src", src, torch.bfloat16, (rows, 64), src.device)
    if src.device.type != "cuda" or rows % 8 or not 0 < rows <= 128:
        raise ValueError(f"swizzle_images: want CUDA bf16 [rows % 8 == 0 up to 128, 64], got "
                         f"{tuple(src.shape)} on {src.device}")
    by_tma, by_function = torch.empty_like(src).view(-1), torch.empty_like(src).view(-1)
    err = lib.zedo_swizzle_check(src.data_ptr(), rows, by_tma.data_ptr(),
                                 by_function.data_ptr(), _stream(src.device))
    if err != 0:
        raise RuntimeError(f"swizzle check launch failed: CUDA error {err}")
    return by_tma, by_function


def fused_score_forward_split(x: torch.Tensor, packed: sk.PackedScoreWeights,
                              vecs: torch.Tensor) -> torch.Tensor:
    """One fused forward in one launch: x [B, C] f32 (C <= io_pad) -> [B, C]
    f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return fused_score_forward_split_reference(x, packed, vecs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_score_forward_split: unsupported device {x.device}")
    lib = load_library()
    sk.check_operands(x, packed, vecs)
    mode = sk.gn_bf16(packed)
    io_pad, h = packed.w_pre.shape
    g = packed.group_size
    tile = check_width(h, g)
    b, c = x.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    # the f32 residual stream, [block][channel][row]
    resid = torch.empty(grid_blocks(b, tile) * tile * h, dtype=torch.float32,
                        device=x.device)
    err = lib.zedo_score_mlp_split_forward(
        x.data_ptr(), b, c, io_pad, h, g, int(mode),
        packed.w_pre.data_ptr(), *(w.data_ptr() for w in packed.w_b),
        packed.w_post.data_ptr(), vecs.data_ptr(), packed.gn_scale.data_ptr(),
        packed.gn_bias.data_ptr(), packed.bias_post.data_ptr(), out.data_ptr(),
        resid.data_ptr(), resid.numel(), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"split score kernel launch failed: CUDA error {err}")
    launch_counts["fused_score_forward_split"] += 1
    return out
