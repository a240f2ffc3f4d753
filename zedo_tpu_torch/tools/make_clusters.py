"""Hypothesis-cluster init poses from a training set.

k-means (scipy's kmeans2, k-means++ seeding) over root-centred training
poses -> [S, j, 3] cluster centres, the `clusters/<dataset>_cluster{S}.npy`
files the solve CLIs read. Port of tools/make_clusters.py; the same poses
and seed give the same bytes.

    python -m zedo_tpu_torch.tools.make_clusters poses.npy clusters/my_cluster5.npy 5
    python -m zedo_tpu_torch.tools.make_clusters --dataset h36m --data_dir data \\
        clusters/h36m_cluster5.npy 5   # the source omitted with --dataset

`poses.npy` is any [N, j, 3] array; --dataset reads the training split
through the port's readers (data.DATASETS).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from scipy.cluster.vq import kmeans2


def make_clusters(poses: np.ndarray, s: int, seed: int = 0) -> np.ndarray:
    """k-means cluster centres of root-centred poses: [N, j, 3] -> [S, j, 3]."""
    poses = np.asarray(poses, np.float64)
    poses = poses - poses[:, 0:1]
    n, j, d = poses.shape
    if s == 1:
        return poses.mean(axis=0, keepdims=True).astype(np.float32)
    centers, _ = kmeans2(poses.reshape(n, j * d), s, minit="++", seed=seed)
    return centers.reshape(s, j, d).astype(np.float32)


def dataset_poses(dataset: str, data_dir: str) -> np.ndarray:
    """The 3D poses of a reader's training split."""
    from zedo_tpu_torch.data import DATASETS

    if dataset not in DATASETS:
        raise SystemExit(f"no reader {dataset!r} (readers: {', '.join(DATASETS)})")
    if dataset in ("mini", "syrip"):
        # the infant readers take (subset, ...) with a data_root
        root = Path(data_dir, "mini-rgbd" if dataset == "mini" else "syrip")
        ds = DATASETS[dataset]("train", gt2d=True, data_root=str(root))
    else:
        ds = DATASETS[dataset](Path(data_dir, dataset), "train", gt2d=True, abs_coord=False)
    return np.asarray(ds.db_3d)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source", nargs="?", default=None,
                    help="[N, j, 3] .npy of training poses (omit with --dataset)")
    ap.add_argument("out", help="output .npy path")
    ap.add_argument("s", type=int, help="number of clusters / hypotheses")
    ap.add_argument("--dataset", default=None,
                    help="read the poses through a reader instead (h36m, 3dpw, ...)")
    ap.add_argument("--data_dir", default="data")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.dataset:
        poses = dataset_poses(args.dataset, args.data_dir)
    elif args.source:
        poses = np.load(args.source)
    else:
        ap.error("provide a source .npy or --dataset")
    clusters = make_clusters(poses, args.s, seed=args.seed)
    np.save(args.out, clusters)
    print(f"wrote {clusters.shape} clusters to {args.out}")
    return clusters


if __name__ == "__main__":
    main()
