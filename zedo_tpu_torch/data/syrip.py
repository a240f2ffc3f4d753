"""SyRIP infant dataset: the port's copy of zedo_tpu/data/syrip.py
(reference lib/dataset/syrip.py).

Stitches corrected 3D (`SyRIP_3d_correction/correct_3D.npy` +
`SyRIP_3d_pred/output_imgnames.npy`) with COCO-json-derived 2D
(`{train,test}_pose2d.npy` dicts, the layout of
zedo_tpu/data/prep/syrip_process.py) keyed by image-name maps
(`{train,test}_rysip.npy`). Synthetic intrinsics: f = 2000, principal point
at the image centre. The COCO-to-12-joint maps keep the reference's negative
indices verbatim. Only the 12-joint convention is coherent. The `aug=True`
branch (prior-training augmentation) waits for the training port
(ROADMAP.md Queue 1, items 13 and 14).
"""
from __future__ import annotations

import os

import numpy as np

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset

CHANGE_2D = [-1, -3, -5, -6, -4, -2, -7, -9, -11, -12, -10, -8]
CHANGE_12 = [2, 1, 0, 3, 4, 5, -3, -2, -1, -4, -5, -6]
SYRIP_FOCAL = 2000


class syrip(PoseDataset):  # noqa: N801 — reference class name
    left_joints = [3, 4, 5, 9, 10, 11]
    right_joints = [0, 1, 2, 6, 7, 8]

    def __init__(self, subset="train", num_joint=17, aug=False, data_root="data/syrip",
                 **kwargs):
        if aug:
            raise NotImplementedError(
                "syrip(aug=True) feeds the prior trainer and waits for the training port "
                "(ROADMAP.md Queue 1, items 13 and 14)")
        self.num_joint = num_joint
        self.data_root = data_root
        self.K: list = []
        super().__init__(subset=subset, **kwargs)

    def read_data(self):
        root = os.path.join(self.data_root, "SyRIP_3d_correction")
        self.img_root = os.path.join(
            self.data_root,
            "images/train_infant" if self.subset == "train" else "images/validate_infant")
        all_name = np.load(os.path.join(self.data_root, "SyRIP_3d_pred/output_imgnames.npy"))
        train_pose_2d = np.load(os.path.join(self.data_root, "train_pose2d.npy"),
                                allow_pickle=True).item()
        test_pose_2d = np.load(os.path.join(self.data_root, "test_pose2d.npy"),
                               allow_pickle=True).item()
        pose_3d = np.load(os.path.join(root, "correct_3D.npy"))
        if self.subset != "train":
            self.subset = "test"
        img_name = np.load(os.path.join(self.data_root, f"{self.subset}_rysip.npy"),
                           allow_pickle=True).item()

        data_3d, data_2d, frame_name, h, w, k_list = [], [], [], [], [], []
        for i, item in enumerate(all_name):
            item = str(item).split("/")[-1]
            if item not in img_name:
                continue
            frame_name.append(os.path.join(self.img_root, img_name[item][0]))
            data_3d.append(pose_3d[i])
            source = train_pose_2d if img_name[item][0] in train_pose_2d else test_pose_2d
            rec = source[img_name[item][0]]
            data_2d.append(np.array(rec["keypoints"])[CHANGE_2D])
            h.append(rec["h"])
            w.append(rec["w"])
            k_list.append(np.array([[SYRIP_FOCAL, 0, rec["w"] / 2],
                                    [0, SYRIP_FOCAL, rec["h"] / 2], [0, 0, 1]]))

        data_3d = np.array(data_3d, dtype=np.float32)
        data_2d = np.array(data_2d, dtype=np.float32)
        frame_name = np.array(frame_name)
        self.h = np.array(h)
        self.w = np.array(w)
        self.K = np.array(k_list, dtype=np.float32)

        if not self.gt2d:
            new_2d = np.load(os.path.join(self.data_root, "dt_syripdata.npy"),
                             allow_pickle=True).item()
            new_2d = new_2d["train"] if self.subset == "train" else new_2d["test"]
            for i in range(len(frame_name)):
                data_2d[i] = np.array(new_2d[frame_name[i].split("/")[-1]])[CHANGE_2D]

        data_3d = data_3d[:, :-2, :]  # drop the two extra SMIL joints

        if self.num_joint != 12:
            # db_2d is already CHANGE_2D-ordered 12-joint COCO, while db_3d
            # without the CHANGE_12 reorder stays in raw order, uncentred:
            # the pairs would be scrambled
            raise ValueError(
                f"syrip supports num_joint=12 only (got {self.num_joint}): its 2D and 3D "
                "sources only align after the CHANGE_12 reorder + pelvis centering")
        data_2d = data_2d[:, CHANGE_12]
        data_3d = data_3d[:, CHANGE_12]
        pelvis = (data_3d[:, 0, :] + data_3d[:, 3, :]) / 2
        data_3d = data_3d - pelvis[:, None, :]

        self.db_2d = data_2d
        self.db_3d = data_3d
        self.frame_name = frame_name
        self.camera_param = self.K

    def _strided_fields(self):
        return ["db_2d", "db_3d", "image_name", "h", "w", "K", "camera_param", "frame_name"]

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None):
        """Mean MPJPE on all 12 joints; the GT is used as stored, NOT
        re-root-centred (the reader pelvis-centred it)."""
        print("eval multi-hypothesis...")
        gt = self.db_3d
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt = gt[::sample_interval]
        report = evaluation.multi_hypothesis_eval(preds, gt, valid_ind=valid_ind,
                                                  protocol2=protocol2)
        print(f"mean MPJPE error: {report.error}")
        return report.error
