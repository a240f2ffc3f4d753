"""Collectives over a Mesh's axes (the port's own helper; JAX leaves these to
GSPMD and XLA).

Each runs over the process group of `axis`: the ranks that share this
rank's other mesh coordinates, in axis-index order. On a mesh of one rank in
a process without torch.distributed each is the identity, as a one-device
JAX mesh allows.

Transport, by backend, decided before the call: NCCL takes CUDA tensors
only, so a CPU tensor on an NCCL group raises. Gloo takes CUDA tensors for
every collective used here (all_reduce, broadcast, all_gather: checked
with PyTorch 2.11 and CUDA 12.8 by two ranks sharing an H100, PERF.md), so
none is staged through host memory by this module.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from zedo_tpu_torch.parallel.mesh import Mesh


def _group(mesh: Mesh, axis: Optional[str]):
    """The process group of `axis` (None: the whole mesh), or None when the
    collective is the identity."""
    mesh.require_member()
    size = mesh.size if axis is None else mesh.axis_size(axis)
    if not dist.is_initialized():
        if size > 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks needs torch.distributed: "
                               f"call parallel.mesh.init_distributed first")
        return None
    if axis is not None and axis not in mesh.shape:
        return None  # an axis the mesh lacks has size 1
    return mesh.group if axis is None else mesh.groups[axis]


def _check_transport(t: torch.Tensor, group, op: str) -> None:
    if dist.get_backend(group) == "nccl" and t.device.type != "cuda":
        raise ValueError(f"{op}: NCCL takes CUDA tensors only, got a {t.device.type} tensor")


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """The ranks' equal-shaped `t` concatenated along `dim` in axis order."""
    group = _group(mesh, axis)
    if group is None:
        return t
    src = t.detach().contiguous()
    _check_transport(src, group, "all_gather")
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_to_host(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """`all_gather` along dim 0 with the result on the host, with one
    device-to-host copy a rank: Gloo gathers the host copy, NCCL gathers on
    the device and copies the result."""
    group = _group(mesh, axis)
    if group is None or dist.get_backend(group) == "gloo":
        host = t.detach().cpu()
        return host if group is None else all_gather(host, mesh, axis)
    return all_gather(t, mesh, axis).cpu()


def psum(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Sum of `t` over the axis, out of place."""
    group = _group(mesh, axis)
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    _check_transport(out, group, "all_reduce")
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmean(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Mean of `t` over the axis (the sum divided by the axis size)."""
    return psum(t, mesh, axis) / mesh.axis_size(axis)


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mesh's first rank's `t` on every rank of the mesh."""
    group = _group(mesh, None)
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    _check_transport(out, group, "broadcast")
    dist.broadcast(out, src=int(mesh.devices.flat[0]), group=group)
    return out


def broadcast_object(obj, mesh: Mesh):
    """The mesh's first rank's picklable `obj` on every rank."""
    group = _group(mesh, None)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(mesh.devices.flat[0]), group=group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    group = _group(mesh, None)
    if group is not None:
        dist.barrier(group=group)


def main_first(mesh: Mesh, fn: Callable):
    """fn() on the mesh's first rank, then on the others: e.g. building the
    kernels, so that no two ranks compile the same library at once."""
    if mesh.is_main:
        out = fn()
        barrier(mesh)
        return out
    barrier(mesh)
    return fn()


class _GatherChannels(torch.autograd.Function):
    """Forward: all-gather along the last dim; backward: the sum over the
    ranks of the gathered gradient, this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, x.shape[-1]
        return all_gather(x, mesh, axis, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        total = psum(grad, ctx.mesh, ctx.axis)
        lo = ctx.mesh.index(ctx.axis) * ctx.width
        return total[..., lo:lo + ctx.width], None, None


class _SumPartials(torch.autograd.Function):
    """Forward: the sum of the ranks' partial sums; backward: the identity
    (each rank's partial gets the whole gradient of the replicated sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def gather_channels(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """Autograd-aware all-gather of channel blocks [..., C/M] -> [..., C]."""
    return _GatherChannels.apply(x, mesh, axis)


def sum_partials(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """Autograd-aware all-reduce (sum) of partial products."""
    return _SumPartials.apply(x, mesh, axis)
