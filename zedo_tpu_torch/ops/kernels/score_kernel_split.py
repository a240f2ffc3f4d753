"""Split ScoreMLP forward: the whole forward in one launch, each row tile
run as two independent half-tile chains.

Port of tools/bench_kernel.py:108 `fwd_split` (body `_kernel_split`), the
TPU experiment that ran each row tile of the fused score kernel as two
half-tile chains so that one half's GroupNorm/SiLU overlaps the other
half's products. The kernel is `csrc/score_mlp_split.cu` (see its header
for the design and what bounds it); it computes exactly the function of
`score_kernel.fused_score_forward` on the same `PackedScoreWeights`, in both
GroupNorm statistics modes.

`fused_score_forward_split` launches the kernel for CUDA tensors and takes
the plain version (`fused_score_forward_split_reference`) only for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.ops.kernels import score_kernel as sk

TILE_ROWS = 32  # rows of the kernel's block: two half chains of 16 rows
CHUNK = 128  # output columns of the kernel's epilogue: groups must divide it

# launches of the CUDA kernel; the wrapper adds one per launch
launch_counts = {"fused_score_forward_split": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def fused_score_forward_split_reference(x: torch.Tensor, packed: sk.PackedScoreWeights,
                                        vecs: torch.Tensor,
                                        tile: int = TILE_ROWS) -> torch.Tensor:
    """Plain version of the split forward, the TPU `_kernel_split` written
    out: the rows are cut into tiles of `tile`, each tile into two halves,
    and the two halves run their chains side by side, layer by layer.
    x [B, C] f32 -> [B, C] f32, the function of the fused forward."""
    b, c = x.shape
    io_pad = packed.w_pre.shape[0]
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
    if _lib is None:
        lib = build.load("score_mlp_split")
        fn = lib.zedo_score_mlp_split_forward
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13
        fn.restype = ctypes.c_int
        for f in (lib.zedo_score_mlp_split_tile_rows, lib.zedo_score_mlp_split_smem_limit):
            f.argtypes = []
            f.restype = ctypes.c_int
        lib.zedo_score_mlp_split_smem_bytes.argtypes = [ctypes.c_int]
        lib.zedo_score_mlp_split_smem_bytes.restype = ctypes.c_int
        if lib.zedo_score_mlp_split_tile_rows() != TILE_ROWS:
            raise RuntimeError("the split kernel's row tile differs from TILE_ROWS")
        _lib = lib
    return _lib


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
    smem, limit = lib.zedo_score_mlp_split_smem_bytes(h), lib.zedo_score_mlp_split_smem_limit()
    if io_pad != CHUNK or h % CHUNK or CHUNK % g or g < 2 or smem > limit:
        raise ValueError(
            f"the split kernel does not take hidden {h} with GroupNorm groups of {g}: it "
            f"needs hidden a multiple of {CHUNK}, groups dividing {CHUNK}, and its two "
            f"half tiles' activations ({smem} bytes of shared memory at this width) "
            f"within the {limit} bytes of a block")
    b, c = x.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    resid = torch.empty((b, h), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.zedo_score_mlp_split_forward(
        x.data_ptr(), b, c, io_pad, h, g, int(mode),
        packed.w_pre.data_ptr(), *(w.data_ptr() for w in packed.w_b),
        packed.w_post.data_ptr(), vecs.data_ptr(), packed.gn_scale.data_ptr(),
        packed.gn_bias.data_ptr(), packed.bias_post.data_ptr(), out.data_ptr(),
        resid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"split score kernel launch failed: CUDA error {err}")
    launch_counts["fused_score_forward_split"] += 1
    return out
