"""3DPW dataset: the port's copy of zedo_tpu/data/pw3d.py (reference
lib/dataset/pw3d.py).

Format: `pw3d_{subset}.npz` with `keypoints3d17_relative` [N, 17+, 3] (their
native joint order), `root_cam` [N, 3], `cam_param` {'f': [N, 2],
'c': [N, 2]}, `image_width/height/path`. Joints are reordered to the H36M
convention through `PW3D_ORDER`; the 2D is always the projection of the GT
3D through K, whatever gt2d says.
"""
from __future__ import annotations

import os

import numpy as np

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset
from zedo_tpu_torch.data.h36m import H36M_ACTIONS

# the reference's order map: new[order[i]] = old[i]
PW3D_ORDER = [5, 2, 6, 3, 11, 14, 12, 15, 13, 16, 1, 4, 8, 10, 0, 7, 9]

# 14-joint evaluation subset of the H36M-17 convention
JOINTS_14 = list(range(1, 7)) + [8] + list(range(10, 17))


class PW3D(PoseDataset):
    """seq5678 selects the single-hypothesis eval's GT source; seq1 is
    accepted and read by nothing, as in the reference."""

    def __init__(self, *args, seq1=False, seq5678=False, **kwargs):
        self.seq1 = seq1
        self.seq5678 = seq5678
        self.gt_dataset = None  # optional caller-set h36m-format GT items
        super().__init__(*args, **kwargs)

    def order_change(self, data):
        out = np.empty_like(data[:17])
        for i in range(17):
            out[PW3D_ORDER[i]] = data[i]
        return out

    def read_data(self):
        file_name = "pw3d_%s.npz" % self.subset
        print("loading %s" % file_name)
        data = np.load(os.path.join(self.root_path, file_name), allow_pickle=True)

        kp3d = data["keypoints3d17_relative"]
        root_cam = data["root_cam"]
        cam_param = data["cam_param"].item()
        width, height, imgpath = data["image_width"], data["image_height"], data["image_path"]

        labels_3d, labels_2d, camera_params, w, h, names = [], [], [], [], [], []
        for i in range(len(kp3d)):
            keypoints3d = self.order_change(kp3d[i, :, :3] + root_cam[i, None, :])
            k = np.array([
                [cam_param["f"][i, 0], 0, cam_param["c"][i, 0]],
                [0, cam_param["f"][i, 1], cam_param["c"][i, 1]],
                [0, 0, 1],
            ])
            keypoint2d = k.dot(keypoints3d.T).T
            keypoint2d = keypoint2d / keypoint2d[:, 2:]
            labels_3d.append(keypoints3d)
            labels_2d.append(keypoint2d)
            camera_params.append(k)
            w.append(width[i])
            h.append(height[i])
            names.append(imgpath[i])

        labels_3d = np.array(labels_3d, dtype=np.float32)
        if not self.abs_coord:
            labels_3d = labels_3d - labels_3d[:, 0:1]
        self.db_3d = labels_3d
        # the homogeneous 1 of the 2D doubles as confidence 1 downstream
        self.db_2d = np.array(labels_2d, dtype=np.float32)
        self.camera_param = np.array(camera_params, dtype=np.float32)
        self.w = np.array(w, dtype=np.float32)
        self.h = np.array(h, dtype=np.float32)
        self.image_name = names

    def _strided_fields(self):
        return ["db_2d", "db_3d", "camera_param", "w", "h", "image_name"]

    def eval(self, preds, protocol2=False, print_verbose=False, sample_interval=None):
        """Single-hypothesis action-wise eval against `_eval_gt_items`;
        sample_interval strides preds and the GT items together."""
        print("eval...")
        gt_items = self._eval_gt_items()
        assert len(preds) == len(gt_items)
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt_items = list(gt_items)[::sample_interval]
        report = evaluation.single_eval(
            preds, evaluation.gt_from_items(gt_items), protocol2=protocol2,
            actions=evaluation.actions_from_items(gt_items), action_order=H36M_ACTIONS)
        if print_verbose:
            evaluation.print_action_table("H36M", protocol2, report.per_action, report.error)
        return report.error

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None, joint=17):
        """Whole-set mean (PA-)MPJPE, min over hypotheses. joint=17 is the
        reference's shipped behaviour; joint=14 scores the 14-joint subset,
        with the alignment still on all 17 joints."""
        print("eval multi-hypothesis...")
        assert len(preds) == len(self.db_3d)
        gt = self.db_3d
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt = gt[::sample_interval]
        gt = gt - gt[:, 0:1]
        report = evaluation.multi_hypothesis_eval(
            preds, gt, valid_ind=valid_ind, protocol2=protocol2,
            joint_subset=JOINTS_14 if joint == 14 else None, subset_before_align=False)
        print(f"mean {'PA-MPJPE' if protocol2 else 'MPJPE'} : {report.error}")
        return report.error
