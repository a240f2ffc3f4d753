"""The yardstick's arithmetic for ZeDO-i's ControlNet adapter:
perfbench/roofline.py's rules (input columns unpadded, 2 operations a
multiply-add, the time path once per distinct time, x, the weights and the
output each read or written once) and peaks.

Row path, C columns, H hidden, n blocks: pre_dense, pre_dense_copy,
zc_layer_2, then a block's dense1, dense2, dense1_copy and zc_b_1, then
post_dense: 3*C*H + (1 + 4n)*H*H multiply-adds a row. Each distinct time:
the shared embedding's E*E, both streams' time projections, 2*(1 + 2n)*E*H,
and each block's zc_b_2 of the overwritten control activation, H*H, which
depends on t alone. Those are the model's operations (`forward_flops`,
which mfu.batch counts), on the published dataflow (Control_ScoreModelFC_Adv
as checked in), whatever an implementation folds.

Kernel #3's bound (`kernel_bound_s`) counts the products the kernel
executes: the folds of csrc/score_mlp_control.cu leave a C x 2H layer 0
(both streams), a 2H x H and an H x H layer a block, and the H x C post
layer, 3*C*H + 3n*H*H multiply-adds a row, the weights of those layers read
once.
"""
from __future__ import annotations

from perfbench import roofline


def row_flops(rows: int, cfg: dict) -> int:
    """Products of the row path for `rows` rows: the trunk's
    (roofline.trunk_flops) and the adapter's."""
    c, h, n = cfg["n_joints"] * cfg["joint_dim"], cfg["hidden_dim"], cfg["n_blocks"]
    return roofline.trunk_flops(rows, cfg) + 2 * rows * (c * h + (1 + 2 * n) * h * h)


def time_flops(times: int, cfg: dict) -> int:
    e, h, n = cfg["embed_dim"], cfg["hidden_dim"], cfg["n_blocks"]
    return 2 * times * (e * e + 2 * (1 + 2 * n) * e * h + n * h * h)


def forward_flops(rows: int, times: int, cfg: dict) -> int:
    """One forward of `rows` rows at `times` distinct times."""
    return row_flops(rows, cfg) + time_flops(times, cfg)


def kernel_flops(rows: int, cfg: dict) -> int:
    """Products kernel #3 executes for `rows` rows."""
    c, h, n = cfg["n_joints"] * cfg["joint_dim"], cfg["hidden_dim"], cfg["n_blocks"]
    return 2 * rows * (3 * c * h + 3 * n * h * h)


def kernel_bytes(rows: int, cfg: dict, weight_bytes: int = 2) -> int:
    """The least traffic of one forward of kernel #3: f32 x read and f32
    output written once, its layers' weights once, the post layer's f32
    bias, and the per-step vectors of its 2 + 2n GroupNorm layers (step
    vector, scale and shift, f32) once."""
    c, h, n = cfg["n_joints"] * cfg["joint_dim"], cfg["hidden_dim"], cfg["n_blocks"]
    weights = 3 * c * h + 3 * n * h * h
    return 2 * rows * c * 4 + weights * weight_bytes + c * 4 + 3 * (2 + 2 * n) * h * 4


def kernel_bound_s(rows: int, cfg: dict, dtype: str = "bf16") -> tuple:
    """(least seconds of one forward of kernel #3, "operations" or "bytes")."""
    ops = kernel_flops(rows, cfg) / roofline.PEAK_FLOPS[dtype]
    traffic = kernel_bytes(rows, cfg) / roofline.PEAK_BYTES_PER_S
    return (ops, "operations") if ops >= traffic else (traffic, "bytes")
