"""The yardstick's arithmetic: the score network's operations and bytes, and
the card's published peaks. Counted from the model's shapes as the inputs
need them, so that the count reads the same work whatever implements it:
input columns unpadded, no lane padding, no GroupNorm indicator products,
the time embedding's products once per distinct time in a call, and x, the
weights and the output each read or written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def trunk_weights(cfg: dict) -> int:
    """Weights of the dense layers on the row path: pre_dense, the blocks'
    2 x n_blocks dense layers, post_dense (their biases too)."""
    c, h = cfg["n_joints"] * cfg["joint_dim"], cfg["hidden_dim"]
    return (c * h + h) + 2 * cfg["n_blocks"] * (h * h + h) + (h * c + c)


def trunk_flops(rows: int, cfg: dict) -> int:
    """Products of the trunk for `rows` rows: 2 per multiply-add."""
    c, h = cfg["n_joints"] * cfg["joint_dim"], cfg["hidden_dim"]
    return 2 * rows * (c * h + 2 * cfg["n_blocks"] * h * h + h * c)


def time_flops(times: int, cfg: dict) -> int:
    """Products of the time path for `times` distinct times: the shared
    embedding's dense layer and the 1 + 2 x n_blocks projections."""
    e, h = cfg["embed_dim"], cfg["hidden_dim"]
    return 2 * times * (e * e + (1 + 2 * cfg["n_blocks"]) * e * h)


def forward_flops(rows: int, times: int, cfg: dict) -> int:
    """One forward of `rows` rows at `times` distinct times."""
    return trunk_flops(rows, cfg) + time_flops(times, cfg)


def kernel_bytes(rows: int, cfg: dict, weight_bytes: int = 2) -> int:
    """Kernel #1's least traffic: f32 x read and f32 output written once,
    the trunk's weights once, and its per-step vectors (the folded time
    projections and the GroupNorm scales and shifts, f32) once."""
    c, h = cfg["n_joints"] * cfg["joint_dim"], cfg["hidden_dim"]
    n_gn = 1 + 2 * cfg["n_blocks"]
    return 2 * rows * c * 4 + trunk_weights(cfg) * weight_bytes + 3 * n_gn * h * 4


def kernel_bound_s(rows: int, cfg: dict, dtype: str = "bf16") -> tuple:
    """(least seconds of one kernel #1 forward, "operations" or "bytes")."""
    ops = trunk_flops(rows, cfg) / PEAK_FLOPS[dtype]
    traffic = kernel_bytes(rows, cfg) / PEAK_BYTES_PER_S
    return (ops, "operations") if ops >= traffic else (traffic, "bytes")


def train_step_flops(rows: int, cfg: dict) -> int:
    """Forward and backward (twice the forward) of a train step, each row
    at its own time."""
    return 3 * forward_flops(rows, rows, cfg)
