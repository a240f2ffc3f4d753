"""Seeded weights of ZeDO-i's ControlNet adapter (Control_ScoreModelFC_Adv),
made on the device.

The trunk is perfbench/weights.py's draw at the same seed (the plain
prior's weights). The adapter's own leaves, every `*_copy` layer, the
`zc_*` bridges and `infant_cond`, come from a second draw of their own,
each leaf independent: the copy branch is not a copy of the trunk and the
bridges are not zero (with zero bridges the adapter is the trunk, which
would hide a fault in the control stream). Dense layers and GroupNorms take
weights.py's ranges; `infant_cond` takes U(-1, 1). Both the program and
the reference receive these same values.
"""
from __future__ import annotations

import math

import torch

from perfbench import scenes, weights

# the draw of the adapter's leaves: its own generator seed from the run's
ADAPTER_STREAM = 6


def adapter_shapes(cfg: dict) -> dict:
    """{leaf name: (shape, kind)} of the adapter's own leaves, in the order
    of the reference's state_dict."""
    h, e = cfg["hidden_dim"], cfg["embed_dim"]
    io = cfg["n_joints"] * cfg["joint_dim"]
    out = {"infant_cond": ((io,), "cond")}

    def lin(name, i, o):
        out[f"{name}.weight"] = ((o, i), i)
        out[f"{name}.bias"] = ((o,), i)

    def gn(name):
        out[f"{name}.weight"] = ((h,), "scale")
        out[f"{name}.bias"] = ((h,), "shift")

    lin("zc_layer_1", io, io)
    lin("zc_layer_2", h, h)
    for b in range(1, cfg["n_blocks"] + 1):
        lin(f"zc_b{b}_1", h, h)
        lin(f"zc_b{b}_2", h, h)
    lin("pre_dense_copy", io, h)
    lin("pre_dense_t_copy", e, h)
    gn("pre_gnorm_copy")
    for b in range(1, cfg["n_blocks"] + 1):
        for i in (1, 2):
            lin(f"b{b}_dense{i}_copy", h, h)
            lin(f"b{b}_dense{i}_t_copy", e, h)
            gn(f"b{b}_gnorm{i}_copy")
    return out


def make(seed: int, cfg: dict, device, dtype=torch.float32) -> dict:
    """{leaf name: tensor}: the trunk of weights.make and the adapter's
    leaves, drawn from `seed` with generators on `device`."""
    out = weights.make(seed, cfg, device, dtype)
    table = adapter_shapes(cfg)
    sizes = [math.prod(s) for s, _ in table.values()]
    gen = torch.Generator(device=device).manual_seed(scenes.step_seed(seed, ADAPTER_STREAM))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    for (name, (shape, kind)), piece in zip(table.items(), flat.split(sizes)):
        if kind == "scale":
            leaf = 1 + 0.1 * piece
        elif kind == "shift":
            leaf = 0.1 * piece
        elif kind == "cond":
            leaf = piece
        else:
            leaf = piece / math.sqrt(kind)
        out[name] = leaf.reshape(shape).to(dtype)
    return out
