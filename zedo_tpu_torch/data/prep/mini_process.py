"""MINI-RGBD raw download -> MINI-RGBD.npy (port of
zedo_tpu/data/prep/mini_process.py, the reference's mini_process.py).

Parses per-sequence `joints_2Ddep/*.txt` (x y [depth] per joint line) and
`joints_3D/*.txt` (x y z per line); sequences 01-10 -> train, 11-12 ->
validate. Output: dict {'train'|'validate': {"<seq>_<2dfile>": {'pose_2d'
[j, 2], 'pose_3d' [j, 3]}}} saved with np.save.

Usage: python -m zedo_tpu_torch.data.prep.mini_process [root [out]]
"""
from __future__ import annotations

import os
import sys

import numpy as np

TRAIN_SEQS = ["01", "02", "03", "04", "05", "06", "07", "08", "09", "10"]
VALIDATE_SEQS = ["11", "12"]


def _parse_joint_file(path: str, n_cols: int) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) >= n_cols:
                rows.append(parts[:n_cols])
    return np.array(rows, dtype=np.float32).reshape(-1, n_cols)


def process(root: str, out_path: str) -> dict:
    d = {"train": {}, "validate": {}}
    for seq in sorted(os.listdir(root)):
        if seq not in TRAIN_SEQS + VALIDATE_SEQS:
            continue
        split = d["train"] if seq in TRAIN_SEQS else d["validate"]
        path_2d = os.path.join(root, seq, "joints_2Ddep")
        path_3d = os.path.join(root, seq, "joints_3D")
        for fname in sorted(os.listdir(path_2d)):
            key = f"{seq}_{fname}"
            split.setdefault(key, {})["pose_2d"] = _parse_joint_file(
                os.path.join(path_2d, fname), 2)
        for fname in sorted(os.listdir(path_3d)):
            # 3D filenames carry 'joints_3D'; keys are named after the 2D files
            key = f"{seq}_{fname}".replace("joints_3D", "joints_2Ddep")
            split.setdefault(key, {})["pose_3d"] = _parse_joint_file(
                os.path.join(path_3d, fname), 3)
    np.save(out_path, d)
    return d


if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "data/mini-rgbd/MINI-RGBD/MINI-RGBD_web/"
    out = sys.argv[2] if len(sys.argv) > 2 else "data/mini-rgbd/MINI-RGBD.npy"
    process(root, out)
