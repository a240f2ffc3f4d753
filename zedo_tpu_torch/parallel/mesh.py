"""Process meshes (port of zedo_tpu/parallel/mesh.py).

JAX is single-controller: one process sees every chip and a `Mesh` places
arrays. The port runs one process per GPU under torch.distributed, launched
with `torchrun` or any launcher that sets RANK and WORLD_SIZE (and
MASTER_ADDR/MASTER_PORT), and keeps JAX's results:

  * `init_distributed` joins the process group with an explicit backend:
    NCCL on `cuda` and Gloo on `cpu` by default. Gloo may be asked for on
    `cuda`; that is how two ranks share one card (NCCL refuses two ranks on
    one GPU). An unknown backend raises, and so does NCCL on the CPU.
  * A `Mesh` holds the world's ranks as a data x model grid with JAX's axis
    names ("data", "model"): its `devices` are ranks, `shape` the axis
    sizes, and it knows this rank's coordinates, the process group of each
    axis and the rank's torch.device. Rank r of a dp x tp mesh has data
    index r // tp and model index r % tp, as JAX's reshape of the device
    list gives them.
  * A rank's rows of a batch are JAX's P("data") placement: contiguous
    blocks in data-index order (`Mesh.row_slice`).

Every rank builds the same meshes in the same order (SPMD): creating a
mesh's axis groups is a collective call of the whole world.
"""
from __future__ import annotations

import atexit
import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from zedo_tpu_torch.utils.config import resolve_device

BACKENDS = ("nccl", "gloo")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The torch.device of a rank: `cuda` without an index is the rank's own
    card, cuda:LOCAL_RANK (torchrun's local rank, else the rank); `cuda:k`
    and `cpu` stay as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return resolve_device(dev)


def init_distributed(backend: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, init_method: Optional[str] = None,
                     device="cuda") -> torch.device:
    """Join the default process group; returns this rank's device.

    rank, world_size: default to torchrun's RANK and WORLD_SIZE; init_method
    to `env://` (MASTER_ADDR, MASTER_PORT). backend: 'nccl' (default on
    cuda) or 'gloo' (default on cpu; on cuda it lets ranks share one card).
    Nothing changes the backend or the device on a failure."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL takes CUDA tensors only; device {device!r} needs "
                         f"backend='gloo'")
    if rank is None or world_size is None:
        missing = [v for v in ("RANK", "WORLD_SIZE") if v not in os.environ]
        if missing:
            raise ValueError(f"init_distributed: pass rank and world_size, or launch with "
                             f"torchrun (missing {', '.join(missing)})")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            device_id=dev if backend == "nccl" else None)
    return dev


def init_from_env(device="cuda") -> bool:
    """The CLIs' bring-up: join the process group when launched as one of
    WORLD_SIZE > 1 ranks (torchrun), and leave it at exit; whether
    torch.distributed is up."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        init_distributed(device=device)
        atexit.register(_leave)
    return dist.is_initialized()


def _leave() -> None:
    # a process that exits with its group alive can abort in the teardown of
    # Gloo's threads ("terminate called without an active exception")
    if dist.is_initialized():
        dist.destroy_process_group()


def say(mesh: Optional["Mesh"], logger_print=print):
    """`logger_print` on the mesh's first rank (or without a mesh), nothing
    on the others: the CLIs' results are printed once."""
    return logger_print if mesh is None or mesh.is_main else (lambda *a, **k: None)


class Mesh:
    """Ranks on named axes. `devices` is an int array of ranks, one array
    dimension per axis name; `device` the torch device this rank computes
    on (see `rank_device`), resolved at first use."""

    def __init__(self, devices, axis_names: tuple, device="cuda"):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        # this rank's index on each axis; None outside the mesh
        self.coords = dict(zip(self.axis_names, map(int, where[0]))) if len(where) else None
        self._device_spec, self._device = device, None
        self.groups, self.group = {}, None
        if dist.is_initialized():
            self._new_groups()

    def _new_groups(self) -> None:
        """The process group of each axis (the ranks that differ only in that
        axis) and of the whole mesh; every rank of the world creates all of
        them, in the same order."""
        world = dist.get_world_size()

        def group(ranks):
            ranks = sorted(int(r) for r in ranks)
            g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            return g if self.rank in ranks else None

        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(-1, self.devices.shape[ax])
            for line in lines:
                g = group(line)
                if g is not None:
                    self.groups[name] = g
        self.group = group(self.devices.ravel())

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = rank_device(self._device_spec, self.rank)
        return self._device

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    @property
    def is_main(self) -> bool:
        """Whether this rank writes files and prints results: the mesh's
        first rank."""
        return self.rank == int(self.devices.flat[0])

    def index(self, axis: str) -> int:
        """This rank's index on `axis` (0 on an axis the mesh lacks)."""
        self.require_member()
        return self.coords.get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def require_member(self) -> None:
        if not self.is_member:
            raise ValueError(f"rank {self.rank} is outside the mesh of ranks "
                             f"{self.devices.ravel().tolist()}")

    def row_slice(self, n: int, axis: str = "data", what: str = "batch") -> slice:
        """This rank's contiguous block of `n` rows sharded over `axis`."""
        size = self.axis_size(axis)
        if n % size:
            raise ValueError(
                f"{what} of {n} rows is not divisible by the mesh's {axis!r} axis size "
                f"{size}: pad it with data.sharding.pad_batch (and pass its mask as "
                f"row_mask)")
        per = n // size
        return slice(self.index(axis) * per, (self.index(axis) + 1) * per)


def default_mesh(devices=None, data_axis: str = "data", model_axis: Optional[str] = None,
                 model_parallel: int = 1, device="cuda") -> Mesh:
    """1-D data mesh over `devices` (ranks; default: the world) by default;
    optionally 2-D (data x model)."""
    devices = list(devices if devices is not None else range(world_size()))
    if model_axis is None or model_parallel <= 1:
        return Mesh(np.array(devices), (data_axis,), device)
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    arr = np.array(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, (data_axis, model_axis), device)


def mesh_from_spec(spec: Optional[str], devices=None, device="cuda") -> Optional[Mesh]:
    """CLI-facing mesh builder, JAX's grammar and messages; `devices` are
    ranks (default: the world).

      'auto'        -> 1-D data mesh over all ranks when >1, else None
      'off'/'none'  -> None (single-device)
      'dp[N]'       -> data mesh over N (default: all) ranks
      'dp[N],tpM'   -> 2-D (data x model) mesh, N*M ranks
    """
    spec = (spec or "auto").strip().lower()
    if spec in ("off", "none", "single", "1"):
        return None
    devices = list(devices if devices is not None else range(world_size()))
    if spec == "auto":
        if len(devices) <= 1:
            return None
        return Mesh(np.array(devices), ("data",), device)
    m = re.fullmatch(r"dp([1-9]\d*)?(?:,tp([1-9]\d*))?", spec)
    if not m:
        raise ValueError(
            f"bad --mesh spec {spec!r}: expected auto|off|dp[N][,tpM] "
            f"with N, M >= 1")
    tp = int(m.group(2) or 1)
    dp = int(m.group(1)) if m.group(1) else max(1, len(devices) // tp)
    need = dp * tp
    if need > len(devices):
        raise ValueError(
            f"--mesh {spec!r} needs {need} devices, have {len(devices)}")
    devices = devices[:need]
    if tp > 1:
        return Mesh(np.array(devices).reshape(dp, tp), ("data", "model"), device)
    return Mesh(np.array(devices), ("data",), device)


def tp_shardings(params: dict) -> dict:
    """Tensor-parallel rule of each ScoreMLP leaf, JAX's test on the shape:
    'row' shards dim 0 (every [hidden, *] weight, checked first, and every
    [hidden] vector), 'col' shards dim 1 ([*, hidden] weights, post_dense),
    'replicated' keeps the whole leaf. Returns a dict shaped like params."""
    hidden = params["pre_dense"]["weight"].shape[0]

    def rule(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 2:
            if shape[0] == hidden:
                return "row"
            if shape[1] == hidden:
                return "col"
        if len(shape) == 1 and shape[0] == hidden:
            return "row"
        return "replicated"

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else rule(v) for k, v in tree.items()}

    return walk(params)
