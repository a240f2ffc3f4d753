"""Seeded weights of the score network, made on the device in one draw.

Every dense layer takes torch's default range, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for its weight and bias; every GroupNorm a scale of
1 + U(-0.1, 0.1) and a bias of U(-0.1, 0.1), so that the affine half of the
normalisation is exercised. `sigmas` is the geometric ladder of the model
config. Both the program and the reference receive these same values.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def shapes(cfg: dict) -> dict:
    """{leaf name: (shape, kind)} of the network in state_dict order."""
    h, e = cfg["hidden_dim"], cfg["embed_dim"]
    io = cfg["n_joints"] * cfg["joint_dim"]
    out = {}

    def lin(name, i, o):
        out[f"{name}.weight"] = ((o, i), i)
        out[f"{name}.bias"] = ((o,), i)

    def gn(name):
        out[f"{name}.weight"] = ((h,), "scale")
        out[f"{name}.bias"] = ((h,), "shift")

    lin("pre_dense", io, h)
    lin("pre_dense_t", e, h)
    gn("pre_gnorm")
    lin("shared_time_embed.0", e, e)
    for b in range(1, cfg["n_blocks"] + 1):
        for i in (1, 2):
            lin(f"b{b}_dense{i}", h, h)
            lin(f"b{b}_dense{i}_t", e, h)
            gn(f"b{b}_gnorm{i}")
    lin("post_dense", h, io)
    return out


def make(seed: int, cfg: dict, device, dtype=torch.float32) -> dict:
    """{leaf name: tensor} drawn from `seed` with a generator on `device`."""
    table = shapes(cfg)
    sizes = [math.prod(s) for s, _ in table.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out = {}
    for (name, (shape, kind)), piece in zip(table.items(), flat.split(sizes)):
        if kind == "scale":
            leaf = 1 + 0.1 * piece
        elif kind == "shift":
            leaf = 0.1 * piece
        else:
            leaf = piece / math.sqrt(kind)
        out[name] = leaf.reshape(shape).to(dtype)
    sigmas = np.exp(np.linspace(math.log(cfg["sigma_max"]), math.log(cfg["sigma_min"]),
                                cfg["num_scales"]))
    out["sigmas"] = torch.as_tensor(sigmas, dtype=dtype, device=device)
    return out


def nested(flat: dict) -> dict:
    """The flat names as the nested dict of the state_dict's dots."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of `nested`."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out
