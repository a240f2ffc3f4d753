"""MPI-INF-3DHP test set: the port's copy of zedo_tpu/data/mpii3dhp.py
(reference lib/dataset/mpii3dHP.py).

GT format: `mpii3d_{subset}.pkl`, a list of dicts with `joint_3d_camera` mm,
`joint_2d`, `w`, `h`, `camera_param` {fx, fy, cx, cy}, `imageid`, `valid_i`,
`action` (1..7, remapped through `ACTION_CONVERTOR`). Valid-frame filtering
happens inside `_sample`. Detected 2D: `mpii_dt_test.npz`, per-sequence
arrays concatenated, TS3/TS4 dropping their first 100 frames, 16 -> 17
joints with a zero, confidence-0 head at slot 10, per-sequence intrinsics.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset

ACTION_CONVERTOR = [15, 17, 10, 18, 19, 20, 21]
ACTIONS_3DHP = [15, 10, 17, 18, 19, 20, 21]
MPII_K = [
    {"cx": 1017.3768231769433, "cy": 1043.0617066309674, "fx": 1500.0026763683243, "fy": 1500.653563770609},
    {"cx": 1015.2332835036037, "cy": 1038.6779735645273, "fx": 1503.7547333381692, "fy": 1501.2960541197708},
    {"cx": 1017.38890576427, "cy": 1043.0479217185737, "fx": 1499.9948168861915, "fy": 1500.5952584161635},
    {"cx": 1017.3629901820193, "cy": 1042.9893946483614, "fx": 1499.889694845776, "fy": 1500.7589012253272},
    {"cx": 939.9366622036999, "cy": 560.196743470783, "fx": 1683.4033373885632, "fy": 1671.9980973522306},
    {"cx": 939.8504013098557, "cy": 560.1146111183259, "fx": 1683.9052204148456, "fy": 1672.674313185811},
]


class MPII3DHP(PoseDataset):
    def read_data(self):
        self.image_path = []
        if self.gt2d:
            file_path = "mpii3d_%s.pkl" % self.subset
            print("loading %s" % file_path)
            with open(os.path.join(self.root_path, file_path), "rb") as f:
                gt_dataset = pickle.load(f)

            n = len(gt_dataset)
            labels_3d = np.empty((n, 17, 3), dtype=np.float32)
            labels_2d = np.empty((n, 17, 3), dtype=np.float32)
            camera_params = np.zeros((n, 3, 3), dtype=np.float32)
            valid_id = []
            for idx, item in enumerate(gt_dataset):
                labels_3d[idx] = item["joint_3d_camera"]
                labels_2d[idx] = item["joint_2d"]
                camera_params[idx][0][0] = item["camera_param"]["fx"]
                camera_params[idx][1][1] = item["camera_param"]["fy"]
                camera_params[idx][0][2] = item["camera_param"]["cx"]
                camera_params[idx][1][2] = item["camera_param"]["cy"]
                camera_params[idx][2][2] = 1
                self.image_path.append(item["imageid"])
                if self.subset == "test" and int(item["valid_i"]) == 1:
                    valid_id.append(idx)
                    item["action"] = ACTION_CONVERTOR[int(item["action"]) - 1]

            if not self.abs_coord:
                labels_3d = labels_3d - labels_3d[:, 0:1]
            labels_3d = labels_3d / 1000.0

            data_2d = labels_2d[..., :2].copy()
            if self.read_confidence:
                data_2d = np.concatenate(
                    (data_2d, np.ones((len(data_2d), 17, 1))), axis=-1).astype(np.float32)
            self.gt_dataset = gt_dataset
            self.valid_id = np.array(valid_id)
        else:
            file_path = os.path.join(self.root_path, "mpii_dt_test.npz")
            print("loading dt_2d mpii_dt_test.npz")
            labels_3d_list, data_2d_list = self.fetch_3dhp(file_path)
            labels_3d = np.concatenate(labels_3d_list).astype(np.float32)
            data_2d = np.concatenate(data_2d_list).astype(np.float32)
            # 16-joint detections -> the 17-joint convention: slot 10 (head)
            # zero-filled and given confidence 0, so the solver does not take
            # pixel (0, 0) for a full-weight observation
            if data_2d.shape[1] == 16:
                d2 = np.zeros((data_2d.shape[0], 17, 3), np.float32)
                d2[:, 0:10, :2] = data_2d[:, 0:10, :2]
                d2[:, 11:, :2] = data_2d[:, 10:, :2]
                d2[:, :, 2] = 1.0
                d2[:, 10, 2] = 0.0
                data_2d = d2
            if labels_3d.shape[1] == 16:
                l3 = np.zeros((labels_3d.shape[0], 17, 3), np.float32)
                l3[:, 0:10] = labels_3d[:, 0:10]
                l3[:, 11:] = labels_3d[:, 10:]
                labels_3d = l3
            # one K row per surviving frame: sequence lengths after the
            # TS3/TS4 drops keep the intrinsics aligned with their frames
            seq_lens = [len(a) for a in labels_3d_list]
            camera_params = np.zeros((sum(seq_lens), 3, 3), dtype=np.float32)
            prev = 0
            for num, length in enumerate(seq_lens):
                cam_p = MPII_K[num]
                camera_params[prev:prev + length, 0, 0] = cam_p["fx"]
                camera_params[prev:prev + length, 1, 1] = cam_p["fy"]
                camera_params[prev:prev + length, 0, 2] = cam_p["cx"]
                camera_params[prev:prev + length, 1, 2] = cam_p["cy"]
                camera_params[prev:prev + length, 2, 2] = 1
                prev += length
            self.gt_dataset = None
            self.valid_id = np.array([])

        self.db_2d = data_2d
        self.db_3d = labels_3d
        self.camera_param = camera_params
        self.image_path = np.array(self.image_path)

    @staticmethod
    def fetch_3dhp(data_path):
        """Per-sequence detected 2D / GT 3D; TS3/TS4 drop their first 100 frames."""
        data = np.load(data_path, allow_pickle=True)
        data3d = data["positions_3d"].item()
        data2d = data["positions_2d"].item()
        out3d, out2d = [], []
        for subject in ["TS1", "TS2", "TS3", "TS4", "TS5", "TS6"]:
            d3 = data3d[subject] - data3d[subject][:, :1]
            start = 100 if subject in ("TS3", "TS4") else 0
            out3d.append(d3[start:] / 1000)
            out2d.append(data2d[subject][start:])
        return out3d, out2d

    def _sample(self, sample_interval):
        """Valid-frame filter, then stride."""
        if len(self.valid_id) != 0:
            v = self.valid_id
            self.db_2d = self.db_2d[v]
            self.db_3d = self.db_3d[v]
            self.gt_dataset = [self.gt_dataset[i] for i in v]
            self.camera_param = self.camera_param[v]
            self.image_path = self.image_path[v]
        self.db_2d = self.db_2d[::sample_interval]
        self.db_3d = self.db_3d[::sample_interval]
        if self.gt_dataset is not None:
            self.gt_dataset = self.gt_dataset[::sample_interval]
        self.camera_param = self.camera_param[::sample_interval]
        self.image_path = self.image_path[::sample_interval]

    def eval(self, preds, protocol2=False, print_verbose=False, sample_interval=None):
        """Action-wise single-hypothesis eval; sample_interval strides preds
        and GT together."""
        print("eval...")
        gt_items = self.gt_dataset
        if gt_items is None:
            raise ValueError(
                "single-hypothesis eval needs the GT pkl branch (gt2d=True); "
                "the detected-2D dataset carries no gt_dataset — use "
                "eval_multi, which handles this case")
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt_items = list(gt_items)[::sample_interval]
        report = evaluation.single_eval(
            preds, evaluation.gt_from_items(gt_items), protocol2=protocol2,
            actions=evaluation.actions_from_items(gt_items), action_order=ACTIONS_3DHP)
        if print_verbose:
            evaluation.print_action_table("3DHP", protocol2, report.per_action, report.error)
        return report.error

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None):
        """GT branch: action-wise, with PCK/AUC on the min-error hypotheses
        and the per-axis hypothesis std. Detected branch: whole-set mean with
        the head joint (10) pinned to GT."""
        print("eval multi-hypothesis...")
        if self.subset == "test" and self.gt_dataset is not None:
            gt_items = self.gt_dataset
            assert len(preds) == len(gt_items)
            if sample_interval is not None:
                preds = preds[::sample_interval]
                gt_items = list(gt_items)[::sample_interval]
            report = evaluation.multi_hypothesis_eval(
                preds, evaluation.gt_from_items(gt_items), protocol2=protocol2,
                valid_ind=valid_ind, actions=evaluation.actions_from_items(gt_items),
                action_order=ACTIONS_3DHP, with_pck_auc=True, with_hypo_std=True)
            print("PCK :", report.pck)
            print("AUC :", report.auc)
            sx, sy, sz = report.hypo_std
            print(f"std: x{sx}, y{sy}, z{sz}")
            if print_verbose:
                evaluation.print_action_table("3DHP", protocol2, report.per_action, report.error)
            return report.error

        assert len(preds) == len(self.db_3d)
        gt3d = self.db_3d
        if sample_interval is not None:
            preds = preds[::sample_interval]
            gt3d = gt3d[::sample_interval]
        preds = torch.as_tensor(preds, dtype=torch.float32).clone()
        preds[:, :, 10, :] = torch.as_tensor(gt3d[:, None, 10, :], device=preds.device)
        report = evaluation.multi_hypothesis_eval(preds, gt3d, valid_ind=valid_ind,
                                                  protocol2=protocol2)
        print(report.error)
        return report.error
