"""Eval-batch sharding helpers (the port's own copy of `contiguous_chunks`,
`pad_batch`, `unpad` and `DistributedEvalSampler` from
zedo_tpu/data/sharding.py; numpy only).

A mesh's rank of data index r takes the r-th of `contiguous_chunks(N, D)`
when D divides N, which is what `pad_batch` makes of any N."""
from __future__ import annotations

import numpy as np


def contiguous_chunks(n: int, num_shards: int) -> list[np.ndarray]:
    """Pad-free contiguous index chunks, sizes differing by at most 1: rank r
    gets indices [start_r, end_r)."""
    base, rem = divmod(n, num_shards)
    chunks, start = [], 0
    for r in range(num_shards):
        size = base + (1 if r < rem else 0)
        chunks.append(np.arange(start, start + size))
        start += size
    return chunks


def pad_batch(arrays, multiple: int, axis: int = 0):
    """Pad the leading axis of every array to a multiple of `multiple` by edge
    replication; returns (padded, mask) where mask [padded_n] is 1 for real
    rows. Edge replication (not zeros) keeps padded rows numerically benign
    inside solvers (no singular K, no 0/0 rays). None entries stay None."""

    def pad_one(a):
        a = np.asarray(a)
        n = a.shape[axis]
        if n == 0:
            raise ValueError("pad_batch got an empty batch (0 rows)")
        target = -(-n // multiple) * multiple
        if target == n:
            return a
        rows = np.repeat(np.take(a, [-1], axis=axis), target - n, axis=axis)
        return np.concatenate([a, rows], axis=axis)

    values = list(arrays.values()) if isinstance(arrays, dict) else list(arrays)
    if all(v is None for v in values):
        raise ValueError("pad_batch got only None arrays")
    if isinstance(arrays, dict):
        padded = {k: None if v is None else pad_one(v) for k, v in arrays.items()}
    else:
        padded = type(arrays)(None if v is None else pad_one(v) for v in arrays)
    n = next(np.asarray(v).shape[axis] for v in values if v is not None)
    mask = np.zeros((-(-n // multiple) * multiple,), np.float32)
    mask[:n] = 1.0
    return padded, mask


def unpad(array: np.ndarray, mask: np.ndarray, axis: int = 0) -> np.ndarray:
    """Strip the padded tail given the mask from `pad_batch`."""
    return np.take(array, np.arange(int(mask.sum())), axis=axis)


class DistributedEvalSampler:
    """The reference's pad-free eval sampler: rank r iterates over the r-th
    of `contiguous_chunks(len(dataset), num_replicas)`, no sample repeated;
    with `shuffle`, in a permutation seeded by seed + epoch (`set_epoch`).
    For DataLoader-style eval loops; the solve CLIs pad with `pad_batch`."""

    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = False, seed: int = 0):
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"Invalid rank {rank}, rank should be in [0, {num_replicas - 1}]")
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._chunks = contiguous_chunks(len(dataset), num_replicas)

    def __iter__(self):
        indices = self._chunks[self.rank]
        if self.shuffle:
            indices = np.random.RandomState(self.seed + self.epoch).permutation(indices)
        return iter(indices.tolist())

    def __len__(self):
        return len(self._chunks[self.rank])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
