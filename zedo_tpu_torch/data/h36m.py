"""Human3.6M dataset: the port's copy of the reader and evaluations of
zedo_tpu/data/h36m.py (reference lib/dataset/h36m.py).

Format: `h36m_{subset}.pkl`, a list of dicts with keys `joint_3d_camera`
[17, 3] mm, `joint_3d_image` [17, 3], `camera_param` {fx, fy, cx, cy},
`image_path`, `action` (int 2..16). Detected 2D (Stacked-Hourglass
fine-tuned): `h36m_sh_dt_ft.pkl` with per-subset `joint3d_image` and
`confidence`. `dataset_eval` scores predictions against another dataset's
GT items (training's evaluation over concatenated sets).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset

H36M_ACTIONS = list(range(2, 17))


class H36MDataset3D(PoseDataset):
    """seq5678 forces the eval GT source to this instance's own `gt_dataset`;
    seq1 is accepted and read by nothing, as in the reference."""

    def __init__(self, *args, seq1=False, seq5678=False, **kwargs):
        self.seq1 = seq1
        self.seq5678 = seq5678
        super().__init__(*args, **kwargs)

    def read_data(self):
        file_name = "h36m_%s.pkl" % self.subset
        print("loading %s" % file_name)
        with open(os.path.join(self.root_path, file_name), "rb") as f:
            gt_dataset = pickle.load(f)

        labels_3d = []
        labels_image_3d = []
        camera_params = []
        for item in gt_dataset:
            labels_3d.append(item["joint_3d_camera"])
            labels_image_3d.append(item["joint_3d_image"])
            k = np.zeros((3, 3), dtype=np.float32)
            k[0][0] = np.asarray(item["camera_param"]["fx"]).item()
            k[1][1] = np.asarray(item["camera_param"]["fy"]).item()
            k[0][2] = np.asarray(item["camera_param"]["cx"]).item()
            k[1][2] = np.asarray(item["camera_param"]["cy"]).item()
            k[2][2] = 1
            camera_params.append(k)
            self.image_name.append(item["image_path"])

        labels_3d = np.array(labels_3d, dtype=np.float32)
        labels_image_3d = np.array(labels_image_3d, dtype=np.float32)
        if not self.abs_coord:
            labels_3d = labels_3d - labels_3d[:, 0:1]
        labels_3d = labels_3d / 1000.0

        if self.gt2d:
            data_2d = labels_image_3d[..., :2].copy()
            if self.read_confidence:
                data_2d = np.concatenate(
                    (data_2d, np.ones((len(data_2d), 17, 1))), axis=-1).astype(np.float32)
        else:
            file_name = "h36m_sh_dt_ft.pkl"
            print("loading dt_2d %s" % file_name)
            with open(os.path.join(self.root_path, file_name), "rb") as f:
                dt_dataset = pickle.load(f)
            data_2d = dt_dataset[self.subset]["joint3d_image"][:, :, :2].copy()
            if self.read_confidence:
                conf = dt_dataset[self.subset]["confidence"].copy()
                data_2d = np.concatenate((data_2d, conf), axis=-1)
            data_2d = data_2d.astype(np.float32)

        self.db_2d = data_2d
        self.db_3d = labels_3d
        self.gt_dataset = gt_dataset
        self.camera_param = np.array(camera_params, dtype=np.float32)
        self.actions = np.array([item["action"] for item in gt_dataset])

    def _strided_fields(self):
        return ["db_2d", "db_3d", "gt_dataset", "camera_param", "image_name", "actions"]

    def eval(self, preds, protocol2=False, print_verbose=False, sample_interval=None):
        """Action-wise (PA-)MPJPE, single hypothesis. sample_interval strides
        preds and the GT items together."""
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

    def dataset_eval(self, preds, dataset, protocol2=True, print_verbose=False,
                     sample_interval=None):
        """Action-wise MPJPE against `dataset.gt_dataset`'s items."""
        print("eval...")
        gt_items = dataset.gt_dataset
        assert len(preds) == len(gt_items)
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt_items = list(gt_items)[::sample_interval]
        report = evaluation.single_eval(
            np.asarray(preds), evaluation.gt_from_items(gt_items), protocol2=protocol2,
            actions=evaluation.actions_from_items(gt_items), action_order=H36M_ACTIONS)
        return report.error

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None):
        """Action-wise (PA-)MPJPE, min over hypotheses; GT source as in
        `eval`. preds [N, S, 17, 3]: an array, or a tensor evaluated on its
        device."""
        print("eval multi-hypothesis...")
        gt_items = self._eval_gt_items()
        assert len(preds) == len(gt_items)
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt_items = list(gt_items)[::sample_interval]
        report = evaluation.multi_hypothesis_eval(
            preds, evaluation.gt_from_items(gt_items), protocol2=protocol2,
            valid_ind=valid_ind, actions=evaluation.actions_from_items(gt_items),
            action_order=H36M_ACTIONS)
        # the reference prints "maximum MPJPE error" here but tracks the
        # minimum: the best case, reported under an honest label, and the
        # worst case beside it
        best = int(np.argmin(report.per_sample_min))
        worst = int(np.argmax(report.per_sample_min))
        print(f"best-case MPJPE: {report.per_sample_min[best]} at sample {best}, "
              f"hypothesis {report.min_hypothesis[best]}")
        print(f"worst-case MPJPE: {report.per_sample_min[worst]} at sample "
              f"{worst}, hypothesis {report.min_hypothesis[worst]}")
        if print_verbose:
            evaluation.print_action_table("H36M", protocol2, report.per_action, report.error)
        return report.error
