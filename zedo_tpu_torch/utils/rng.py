"""The random draws of the port's train step: a torch.Generator's own, or
the global batch's sliced to a rank's block (ShardedGenerator).

On a mesh the train step keeps the global batch's semantics, as JAX's
GSPMD-partitioned step does: every rank seeds the same generator, draws what
one device would draw for the whole batch (the times, the noise, the dropout
masks, the condition masks) and keeps its own rows and, for a hidden
activation under tensor parallelism, its own channels. The draw sites of the
train step (`diffusion.losses`, `diffusion.sde._randn`, `models.nn.dropout`,
`models.score_mlp_cond.random_mask_condition`) go through `rand`, `randn`
and `randint` here, which take a torch.Generator (the draw itself) or a
ShardedGenerator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """A generator whose draws are the global batch's, sliced: `rows` of
    `total_rows` (dim 0) and, for hidden activations, `cols` of
    `total_cols` (the last dim)."""

    generator: torch.Generator
    rows: slice
    total_rows: int
    cols: Optional[slice] = None
    total_cols: Optional[int] = None


def _raw(kind: str, gen: torch.Generator, shape, dtype, device, high=None) -> torch.Tensor:
    if kind == "rand":
        return torch.rand(shape, generator=gen, dtype=dtype, device=device)
    if kind == "randn":
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return torch.randint(0, high, shape, generator=gen, device=device)


def _draw(kind, gen, shape, dtype, device, channels=False, high=None) -> torch.Tensor:
    if not isinstance(gen, ShardedGenerator):
        return _raw(kind, gen, tuple(shape), dtype, device, high)
    shape = list(shape)
    if shape[0] != gen.rows.stop - gen.rows.start:
        raise ValueError(f"draw of {shape[0]} rows for a shard of rows {gen.rows}")
    shape[0] = gen.total_rows
    if channels and gen.cols is not None:
        shape[-1] = gen.total_cols
        return _raw(kind, gen.generator, tuple(shape), dtype, device, high)[
            gen.rows, ..., gen.cols]
    return _raw(kind, gen.generator, tuple(shape), dtype, device, high)[gen.rows]


def rand(gen, shape, dtype=None, device=None, channels: bool = False) -> torch.Tensor:
    """U[0, 1) of `shape`; `channels`: the last dim is a hidden activation's
    channels (sliced under tensor parallelism)."""
    return _draw("rand", gen, shape, dtype, device, channels)


def randn(gen, shape, dtype=None, device=None) -> torch.Tensor:
    return _draw("randn", gen, shape, dtype, device)


def randint(gen, high: int, shape, device=None) -> torch.Tensor:
    return _draw("randint", gen, shape, None, device, high=high)
