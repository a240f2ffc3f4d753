"""MINI-RGBD infant dataset: the port's copy of zedo_tpu/data/mini_rgbd.py
(reference lib/dataset/mini_rgbd.py).

Format: `MINI-RGBD.npy`, a dict {'train'|'validate': {frame_key:
{'pose_2d' [25, 2], 'pose_3d' [25, 3]}}} (the layout of
zedo_tpu/data/prep/mini_process.py). Fixed Kinect intrinsics; SMIL-25 joints
mapped to H36M-17 by `SMIL_TO_H36M`, optionally down to 12 by
`CHANGE_TO_12`. The `aug=True` branch (prior-training augmentation) waits
for the training port (ROADMAP.md Queue 1, items 13 and 14).
"""
from __future__ import annotations

import os

import numpy as np

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset

SMIL_TO_H36M = [0, 2, 5, 11, 1, 4, 10, 3, 9, 12, 15, 13, 18, 20, 14, 19, 21]
CHANGE_TO_12 = [1, 2, 3, 4, 5, 6, 11, 12, 13, 14, 15, 16]
MINI_K = dict(
    fx=588.67905803875317, fy=590.25690113005601,
    cx=322.22048191353628, cy=237.46785983766890,
)


def mini_intrinsics() -> np.ndarray:
    """The fixed Kinect K [3, 3] f32."""
    k = np.zeros((3, 3), dtype=np.float32)
    k[0, 0], k[1, 1] = MINI_K["fx"], MINI_K["fy"]
    k[0, 2], k[1, 2] = MINI_K["cx"], MINI_K["cy"]
    k[2, 2] = 1
    return k


class mini_rgbd(PoseDataset):  # noqa: N801 — reference class name
    def __init__(self, subset="train", num_joint=17, aug=False, normed=False,
                 data_root="data/mini-rgbd", **kwargs):
        if aug:
            raise NotImplementedError(
                "mini_rgbd(aug=True) feeds the prior trainer and waits for the training "
                "port (ROADMAP.md Queue 1, items 13 and 14)")
        self.num_joint = num_joint
        self.normed = normed
        self.data_root = data_root
        self.K: list = []
        super().__init__(subset=subset, **kwargs)

    @staticmethod
    def norm(pose_3d):
        return 2 * (pose_3d - pose_3d.min()) / (pose_3d.max() - pose_3d.min()) - 1

    def read_data(self):
        data = np.load(os.path.join(self.data_root, "MINI-RGBD.npy"), allow_pickle=True).item()
        data = data[self.subset]

        pose_3d, pose_2d, frame_name = [], [], []
        k = mini_intrinsics()
        for item in data.keys():
            pose_3d.append(data[item]["pose_3d"])
            pose_2d.append(data[item]["pose_2d"])
            self.K.append(k.copy())
            frame_name.append(item)

        pose_3d = np.array(pose_3d, dtype=np.float32)
        pose_2d = np.array(pose_2d, dtype=np.float32)

        if not self.abs_coord:
            self.root = pose_3d[:, 0:1]
            pose_3d = pose_3d - pose_3d[:, 0:1]
        if self.normed:
            pose_3d = self.norm(pose_3d)

        if self.num_joint == 17:
            pose_2d = pose_2d[:, SMIL_TO_H36M]
            pose_3d = pose_3d[:, SMIL_TO_H36M]
        if self.num_joint == 12:
            pose_2d = pose_2d[:, CHANGE_TO_12, :]
            pose_3d = pose_3d[:, CHANGE_TO_12, :]
            # flip maps in the 12-joint ordering (positions of the H36M-17
            # left/right joints inside CHANGE_TO_12)
            self.left_joints = [3, 4, 5, 6, 7, 8]
            self.right_joints = [0, 1, 2, 9, 10, 11]

        self.db_2d = pose_2d
        self.db_3d = pose_3d
        self.frame_name = np.array(frame_name)
        self.camera_param = np.array(self.K) if len(self.K) else np.zeros_like(pose_3d)

    def _strided_fields(self):
        return ["db_2d", "db_3d", "image_name", "camera_param", "frame_name"]

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None):
        """Mean MPJPE; with 12 joints, prediction and GT are reduced to the
        joints [1:7] + [11] BEFORE alignment, as the reference does."""
        print("eval multi-hypothesis...")
        gt = self.db_3d
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt = gt[::sample_interval]
        gt = gt - gt[:, 0:1]
        subset = list(range(1, 7)) + [11] if gt.shape[-2] == 12 else None
        report = evaluation.multi_hypothesis_eval(preds, gt, valid_ind=valid_ind,
                                                  protocol2=protocol2, joint_subset=subset,
                                                  subset_before_align=True)
        print(f"mean MPJPE error: {report.error}")
        return report.error
