"""MINI-RGBD infant dataset: the port's copy of zedo_tpu/data/mini_rgbd.py
(reference lib/dataset/mini_rgbd.py).

Format: `MINI-RGBD.npy`, a dict {'train'|'validate': {frame_key:
{'pose_2d' [25, 2], 'pose_3d' [25, 3]}}} (the layout of
zedo_tpu/data/prep/mini_process.py). Fixed Kinect intrinsics; SMIL-25 joints
mapped to H36M-17 by `SMIL_TO_H36M`, optionally down to 12 by
`CHANGE_TO_12`. `aug=True` appends the prior-only 3D rows of `aug_path`,
each shrunk by a random factor in [0.8, 1.2] from the dataset's
RandomState; then, as in the reference, the 2D, the frame names and K are
replaced wholesale by zeros (K by a malformed [N, j, 3] zero array), so only
the prior trainer (which reads db_3d alone) can use such a set.
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
    def __init__(self, subset="train", num_joint=17, aug=False, scale=1.0, normed=False,
                 cls=False, data_root="data/mini-rgbd", aug_path="aug_mini.npy",
                 save_gt_path=None, **kwargs):
        self.num_joint = num_joint
        self.aug = aug
        self.scale = scale
        self.normed = normed
        self.cls = cls
        self.data_root = data_root
        self.aug_path = aug_path
        self.save_gt_path = save_gt_path  # the reference saves its GT on load; opt-in
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
        frame_name = np.array(frame_name)

        if not self.abs_coord:
            self.root = pose_3d[:, 0:1]
            pose_3d = pose_3d - pose_3d[:, 0:1]
        if self.normed:
            pose_3d = self.norm(pose_3d)

        if self.num_joint == 17:
            pose_2d = pose_2d[:, SMIL_TO_H36M]
            pose_3d = pose_3d[:, SMIL_TO_H36M]

        if self.aug:
            aug_data = np.load(self.aug_path)
            aug_data = aug_data / self.rng.uniform(0.8, 1.2, (len(aug_data), 1, 1))
            pose_3d = np.concatenate([pose_3d, aug_data.astype(np.float32)], axis=0)
            if len(pose_2d) != len(pose_3d):
                pose_2d = np.zeros_like(pose_3d)
                frame_name = np.zeros(len(pose_3d))
                self.K = np.zeros_like(pose_3d)

        if self.num_joint == 12:
            pose_2d = pose_2d[:, CHANGE_TO_12, :]
            pose_3d = pose_3d[:, CHANGE_TO_12, :]
            # flip maps in the 12-joint ordering (positions of the H36M-17
            # left/right joints inside CHANGE_TO_12)
            self.left_joints = [3, 4, 5, 6, 7, 8]
            self.right_joints = [0, 1, 2, 9, 10, 11]

        if self.save_gt_path:
            np.save(self.save_gt_path, pose_3d)

        self.db_2d = pose_2d
        self.db_3d = pose_3d
        self.frame_name = frame_name
        self.camera_param = np.array(self.K) if len(self.K) else np.zeros_like(pose_3d)

    def _strided_fields(self):
        return ["db_2d", "db_3d", "image_name", "camera_param", "frame_name"]

    def __getitem__(self, idx):
        """(data_2d, data_3d, K), and the class label [0, 1] with `cls`."""
        data_2d = self.db_2d[idx % self.real_data_len]
        data_3d = self.db_3d[idx % self.real_data_len]
        k = self.camera_param[idx % self.real_data_len]
        if self.scale > 1:
            data_3d = data_3d * self.scale
        if self.cls:
            data_2d = np.concatenate([data_2d, np.ones((data_2d.shape[0], 1))], axis=-1)
            return data_2d, data_3d, k, np.array([0, 1])
        return data_2d, data_3d, k

    def save_action(self, action):
        """Attach per-sample action labels, one per pose."""
        self.action = action
        assert len(self.db_3d) == len(self.action)
        return self.action

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None, sample=None, mask_tok=None):
        """Mean MPJPE; with 12 joints, prediction and GT are reduced to the
        joints [1:7] + [11] BEFORE alignment, as the reference does.
        `sample` and `mask_tok` are accepted and unused, as in JAX."""
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
