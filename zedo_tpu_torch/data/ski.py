"""SkiPose dataset: the port's copy of zedo_tpu/data/ski.py (reference
lib/dataset/skiPose.py).

Format: `ski_test.h5` with datasets `seq`, `cam`, `frame`, `cam_intrinsic`
(normalized: multiplied by 256, K[2,2] reset to 1), `3D` [N, j*3], `2D`
[N, j*2] in 0..1 (scaled by 256). Reading it needs `h5py`, imported by the
reader alone.
"""
from __future__ import annotations

import os

import numpy as np

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset


class skiPose(PoseDataset):  # noqa: N801 — reference class name
    def read_data(self):
        try:
            import h5py
        except ImportError as e:
            raise ImportError("the SkiPose reader needs h5py to read ski_test.h5") from e

        file_name = os.path.join(self.root_path, "ski_test.h5")
        print("loading %s" % file_name)
        labels_3d, labels_2d, camera_params, image_name = [], [], [], []
        with h5py.File(file_name, "r") as h5:
            for index in range(len(h5["seq"])):
                cam = np.asarray(h5["cam_intrinsic"][index]) * 256
                cam[2, 2] = 1
                pose_3d = np.asarray(h5["3D"][index]).reshape([-1, 3])
                pose_2d = np.ones_like(pose_3d)
                pose_2d[:, :2] = np.asarray(h5["2D"][index]).reshape([-1, 2]) * 256
                seq = int(np.asarray(h5["seq"][index]).item())
                cam_id = int(np.asarray(h5["cam"][index]).item())
                frame = int(np.asarray(h5["frame"][index]).item())
                image_name.append(
                    "test/seq_{:03d}/cam_{:02d}/image_{:06d}.png".format(seq, cam_id, frame))
                labels_3d.append(pose_3d)
                labels_2d.append(pose_2d)
                camera_params.append(cam)

        labels_3d = np.array(labels_3d, dtype=np.float32)
        if not self.abs_coord:
            labels_3d = labels_3d - labels_3d[:, 0:1]
        self.db_3d = labels_3d
        self.db_2d = np.array(labels_2d, dtype=np.float32)
        self.camera_param = np.array(camera_params, dtype=np.float32)
        self.image_name = image_name

    def _strided_fields(self):
        # the reference strides only db_2d/db_3d/camera_param
        return ["db_2d", "db_3d", "camera_param"]

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None):
        """Whole-set mean (PA-)MPJPE."""
        print("eval multi-hypothesis...")
        assert len(preds) == len(self.db_3d)
        gt = self.db_3d
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt = gt[::sample_interval]
        gt = gt - gt[:, 0:1]
        report = evaluation.multi_hypothesis_eval(preds, gt, valid_ind=valid_ind,
                                                  protocol2=protocol2)
        print(f"mean {'PA-MPJPE' if protocol2 else 'MPJPE'} : {report.error}")
        return report.error
