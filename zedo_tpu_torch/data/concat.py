"""Dataset concatenation: the port's copy of zedo_tpu/data/concat.py (the
reference's torch ConcatDataset of the syrip_concat training mix)."""
from __future__ import annotations

import numpy as np


class ConcatDataset:
    """Concatenate datasets along the sample axis; exposes the array fields
    the trainer and eval helpers need (db_2d/db_3d/camera_param/gt_dataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.db_3d = np.concatenate([np.asarray(d.db_3d) for d in self.datasets])
        arrs_2d = [np.asarray(d.db_2d) for d in self.datasets]
        # members may disagree on the trailing channel only (e.g. syrip's
        # COCO keypoints carry a confidence channel); trim to the common
        # x/y(/conf) prefix rather than silently zeroing everything
        c = min(a.shape[-1] for a in arrs_2d)
        self.db_2d = np.concatenate([a[..., :c] for a in arrs_2d])
        cams = [getattr(d, "camera_param", None) for d in self.datasets]
        if all(c is not None and len(c) for c in cams):
            self.camera_param = np.concatenate([np.asarray(c) for c in cams])
        else:
            self.camera_param = None
        gts = [getattr(d, "gt_dataset", None) for d in self.datasets]
        self.gt_dataset = (
            sum((list(g) for g in gts), []) if all(g is not None for g in gts) else None
        )
        self._lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lengths)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self._lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)

    def _aug_delegate(self):
        """Members must agree on the flip/rot joint maps for batch augs."""
        d0 = self.datasets[0]
        for d in self.datasets[1:]:
            if not (d.left_joints == d0.left_joints
                    and d.right_joints == d0.right_joints
                    and d.flip == d0.flip and d.rot == d0.rot):
                raise ValueError(
                    "concat members disagree on flip/rot joint maps; "
                    "per-member batch augmentation is not supported")
        return d0

    def _member_aug(self, method):
        """The members' aug method, or an error: these methods run only when
        augmentation was asked for, and a member that cannot augment must
        not return the batch unchanged (train_loop finds this class's
        method by getattr, so the concat re-imposes the members' contract)."""
        d0 = self.datasets[0]
        if not hasattr(d0, method):
            raise ValueError(
                f"augmentation requested but concat member "
                f"{type(d0).__name__} provides no {method}")
        return getattr(self._aug_delegate(), method)

    def augment_batch(self, batch_3d, rng):
        """Batch flip/rotate augs; valid where the members share the flip
        joint maps (checked, not assumed)."""
        return self._member_aug("augment_batch")(batch_3d, rng)

    def augment_batch_cond(self, batch_3d, cond2d, rng):
        """Joint (pose, condition) flip aug: PoseDataset.augment_batch_cond."""
        return self._member_aug("augment_batch_cond")(batch_3d, cond2d, rng)
