"""Tensor parallelism of the ScoreMLP over a mesh's model axis: what JAX's
train step gets from `parallel.mesh.tp_shardings` and GSPMD
(zedo_tpu/train/trainer.py:242-254).

Each leaf follows its `tp_shardings` rule: a 'row' leaf holds this rank's
block of the hidden channels (its dim 0), the 'col' post_dense weight its
block of the input channels (dim 1), a 'replicated' leaf the whole leaf.
`make_apply` is score_mlp.apply on such shards, through its hooks:

  * each row-sharded layer computes its block of the output channels from
    the all-gathered input (pre_dense and the time layers read the
    replicated pose and time embedding);
  * GroupNorm runs on whole local groups, so hidden / M has to be a
    multiple of the group size hidden / groups (`check` raises otherwise);
  * post_dense gives partial sums over its block of channels, all-reduced;
    its bias is added on the axis's first rank, before the sum.

A sharded leaf's gradient is its block's; a replicated leaf's gradient is
the sum over the axis of each rank's contribution (train.trainer sums it).
"""
from __future__ import annotations

import functools
import re

import torch

from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.nn import tree_replace, tree_to_flat
from zedo_tpu_torch.parallel import collectives
from zedo_tpu_torch.parallel.mesh import Mesh, tp_shardings

_DIM = {"row": 0, "col": 1}


def expected_rule(name: str) -> str:
    """The rule `make_apply` reads each ScoreMLP leaf with."""
    if name == "post_dense.weight":
        return "col"
    if re.match(r"(pre_dense|pre_dense_t|pre_gnorm|b\d+_(dense[12]|dense[12]_t|gnorm[12]))\.",
                name):
        return "row"
    return "replicated"


def check(params: dict, cfg: score_mlp.ScoreMLPConfig, mesh: Mesh, axis: str = "model") -> dict:
    """The flat {name: rule} of `params` under `tp_shardings`; raises where
    the tensor-parallel forward cannot take the model on this axis."""
    m = mesh.axis_size(axis)
    hidden, group = cfg.hidden_dim, cfg.hidden_dim // cfg.group_norm_groups
    if hidden % m or (hidden // m) % group:
        raise ValueError(
            f"tensor parallelism over {m} ranks: hidden {hidden} / {m} is not a multiple of "
            f"the GroupNorm group of {group} channels (hidden / group_norm_groups)")
    rules = tree_to_flat(tp_shardings(params))
    for name, rule in rules.items():
        if rule != expected_rule(name):
            raise ValueError(
                f"tensor-parallel ScoreMLP: tp_shardings gives {name} the rule {rule!r}, the "
                f"forward reads it {expected_rule(name)!r} (a width equal to hidden_dim "
                f"{hidden}?)")
    return rules


def shard_leaf(t: torch.Tensor, rule: str, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    if rule == "replicated":
        return t
    return t.chunk(mesh.axis_size(axis), dim=_DIM[rule])[mesh.index(axis)].clone()


def gather_leaf(t: torch.Tensor, rule: str, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    if rule == "replicated":
        return t
    return collectives.all_gather(t, mesh, axis, dim=_DIM[rule])


def shard_tree(tree: dict, rules: dict, mesh: Mesh, axis: str = "model") -> dict:
    """Each leaf of a full params-shaped tree cut to this rank's block."""
    flat = tree_to_flat(tree)
    return tree_replace(tree, {n: shard_leaf(t, rules[n], mesh, axis) for n, t in flat.items()})


def gather_tree(tree: dict, rules: dict, mesh: Mesh, axis: str = "model") -> dict:
    """The full leaves of a sharded params-shaped tree, on every rank."""
    flat = tree_to_flat(tree)
    return tree_replace(tree, {n: gather_leaf(t, rules[n], mesh, axis) for n, t in flat.items()})


def make_apply(mesh: Mesh, axis: str = "model"):
    """score_mlp.apply over the shards of a model on `axis` of `mesh`: its
    hooks gather each residual layer's input and sum post_dense's partial
    products, the bias joining on the axis's first rank."""

    def gather(h: torch.Tensor) -> torch.Tensor:
        return collectives.gather_channels(h, mesh, axis)

    def reduce(product: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        if mesh.index(axis) == 0:
            product = product + bias
        return collectives.sum_partials(product, mesh, axis)

    return functools.partial(score_mlp.apply, gather=gather, reduce=reduce)
