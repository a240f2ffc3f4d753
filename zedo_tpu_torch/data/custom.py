"""Custom in-the-wild dataset (`wild`): the port's copy of
zedo_tpu/data/custom.py (reference lib/dataset/custom.py).

Point it at an .npz/.npy file with
    keypoints_2d: [N, 17, 3]  (x, y, confidence)
    keypoints_3d: [N, 17, 3]  (zeros are fine for inference only)
    K:            [N, 3, 3]
    image_name:   [N]          (optional)
or subclass and override `read_data`.
"""
from __future__ import annotations

import os

import numpy as np

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.data.base import PoseDataset


class CustomDataset(PoseDataset):
    def __init__(self, root_path, sample_interval=None, file_name="custom_data.npz",
                 **kwargs):
        self.file_name = file_name
        super().__init__(root_path=root_path, subset="test",
                         sample_interval=sample_interval, **kwargs)

    def read_data(self):
        path = os.path.join(self.root_path, self.file_name)
        print("loading %s" % path)
        data = np.load(path, allow_pickle=True)
        if hasattr(data, "item") and not hasattr(data, "files"):
            data = data.item()
        self.db_2d = np.asarray(data["keypoints_2d"], dtype=np.float32)
        self.db_3d = np.asarray(data["keypoints_3d"], dtype=np.float32)
        self.camera_param = np.asarray(data["K"], dtype=np.float32)
        self.image_name = list(data["image_name"]) if "image_name" in data else [
            str(i) for i in range(len(self.db_2d))]

    def eval_multi(self, preds, protocol2=False, print_verbose=False,
                   sample_interval=None, valid_ind=None):
        """Whole-set mean (PA-)MPJPE with root-centred GT."""
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
