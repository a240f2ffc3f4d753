"""Pose figures for qualitative checks (port of zedo_tpu/utils/visualize.py).

    from zedo_tpu_torch.utils.visualize import save_pose_grid
    save_pose_grid("out.png", poses_3d=pred[:8], poses_2d=kp2d[:8])

matplotlib is imported inside the functions that draw, so importing this
module needs no matplotlib; drawing without it raises an ImportError naming
the package. Inputs are numpy arrays (or anything np.asarray takes).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from zedo_tpu_torch.data.base import H36M_SKELETON


def _require_matplotlib():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("zedo_tpu_torch.utils.visualize draws with matplotlib, which is "
                          "not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pose_3d(ax, pose: np.ndarray, skeleton: Sequence = H36M_SKELETON,
                 color: str = "tab:blue", gt: Optional[np.ndarray] = None):
    """Draw one [j, 3] pose (and optionally a GT overlay) on a 3D axis."""
    pose = np.asarray(pose)
    for a, b in skeleton:
        if a < len(pose) and b < len(pose):
            ax.plot(*zip(pose[a], pose[b]), color=color, linewidth=2)
    ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], s=8, color=color)
    if gt is not None:
        gt = np.asarray(gt)
        for a, b in skeleton:
            if a < len(gt) and b < len(gt):
                ax.plot(*zip(gt[a], gt[b]), color="tab:gray", linewidth=1, linestyle="--")
    ax.invert_zaxis()  # camera frame: y grows downward
    ax.set_box_aspect((1, 1, 1))


def plot_pose_2d(ax, pose2d: np.ndarray, skeleton: Sequence = H36M_SKELETON,
                 color: str = "tab:red", image_size: Optional[tuple] = None):
    """Draw one [j, >=2] 2D pose on a 2D axis (image coordinates)."""
    pose2d = np.asarray(pose2d)
    for a, b in skeleton:
        if a < len(pose2d) and b < len(pose2d):
            ax.plot([pose2d[a, 0], pose2d[b, 0]], [pose2d[a, 1], pose2d[b, 1]],
                    color=color, linewidth=2)
    ax.scatter(pose2d[:, 0], pose2d[:, 1], s=8, color=color)
    if image_size is not None:
        ax.set_xlim(0, image_size[0])
        ax.set_ylim(image_size[1], 0)
    else:
        ax.invert_yaxis()
    ax.set_aspect("equal")


def save_pose_grid(path: str, poses_3d: np.ndarray, poses_2d: Optional[np.ndarray] = None,
                   gts_3d: Optional[np.ndarray] = None, skeleton: Sequence = H36M_SKELETON,
                   cols: int = 4) -> str:
    """Save a grid figure, one (2D, 3D) pair per sample: poses_3d [N, j, 3],
    poses_2d [N, j, >=2] optional, gts_3d [N, j, 3] an optional overlay."""
    plt = _require_matplotlib()
    n = len(poses_3d)
    rows = (n + cols - 1) // cols
    per = 2 if poses_2d is not None else 1
    fig = plt.figure(figsize=(3 * cols * per, 3 * rows))
    for i in range(n):
        if poses_2d is not None:
            ax2 = fig.add_subplot(rows, cols * per, per * i + 1)
            plot_pose_2d(ax2, poses_2d[i], skeleton)
            ax2.set_title(f"#{i} 2D", fontsize=8)
        ax3 = fig.add_subplot(rows, cols * per, per * i + per, projection="3d")
        plot_pose_3d(ax3, poses_3d[i], skeleton, gt=None if gts_3d is None else gts_3d[i])
        ax3.set_title(f"#{i} 3D", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
