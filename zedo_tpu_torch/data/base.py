"""Shared dataset skeleton: the port's copy of zedo_tpu/data/base.py (numpy
and scipy only).

Subclasses implement `read_data` (format-faithful readers) and
`eval`/`eval_multi` on top of data/evaluation.py. The train-time
augmentations (`__getitem__`'s flips and rotations, `augment_batch`,
`augment_batch_cond`, `add_noise`) draw from numpy RandomStates, so they
give the JAX package's results for the same state exactly.

H36M 17-joint convention throughout: 0 pelvis, 1-3 R leg, 4-6 L leg, 7 spine,
8 thorax, 9 neck/nose, 10 head, 11-13 L arm, 14-16 R arm.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

LEFT_JOINTS = [4, 5, 6, 11, 12, 13]
RIGHT_JOINTS = [1, 2, 3, 14, 15, 16]

H36M_SKELETON = [
    [0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6],
    [0, 7], [7, 8], [8, 9], [9, 10], [8, 11], [11, 12], [12, 13],
    [8, 14], [14, 15], [15, 16],
]


def flip_data(data: np.ndarray) -> np.ndarray:
    """Append horizontally flipped copies: [N, 17*k]|[N, 17, k] -> [2N, ...]."""
    flipped = data.copy().reshape((len(data), 17, -1))
    flipped[:, :, 0] *= -1
    flipped[:, LEFT_JOINTS + RIGHT_JOINTS] = flipped[:, RIGHT_JOINTS + LEFT_JOINTS]
    flipped = flipped.reshape(data.shape)
    return np.concatenate((data, flipped), axis=0)


def unflip_data(data: np.ndarray) -> np.ndarray:
    """Average original and flipped halves: [2N, 17*3] -> [N, 17*3]."""
    data = data.copy().reshape((2, -1, 17, 3))
    data[1, :, :, 0] *= -1
    data[1, :, LEFT_JOINTS + RIGHT_JOINTS] = data[1, :, RIGHT_JOINTS + LEFT_JOINTS]
    return np.mean(data, axis=0).reshape((-1, 17 * 3))


def normalize_data(data: np.ndarray) -> np.ndarray:
    """Pixel coords -> [-1, 1] image frame, 1000x1000 canvas."""
    res_w, res_h = 1000, 1000
    assert data.ndim >= 3
    data = data.copy()
    data[..., :2] = data[..., :2] / res_w * 2 - [1, res_h / res_w]
    data[..., 2:] = data[..., 2:] / res_w * 2
    return data


def denormalize_data(data: np.ndarray, which: str = "scale") -> np.ndarray:
    """Inverse of normalize_data."""
    res_w, res_h = 1000, 1000
    assert data.ndim >= 3
    if which != "scale":
        raise AssertionError
    data = data.copy()
    data[..., :2] = (data[..., :2] + [1, res_h / res_w]) * res_w / 2
    data[..., 2:] = data[..., 2:] * res_w / 2
    return data


class PoseDataset:
    """Common ctor wiring, item access, the train-time augmentations and the
    tensors a solver and an evaluation read.

    Subclasses set db_2d [N, j, 2|3], db_3d [N, j, 3], camera_param [N, 3, 3]
    (and whatever extras) in `read_data`, called by `__init__`."""

    left_joints = LEFT_JOINTS
    right_joints = RIGHT_JOINTS

    def __init__(
        self,
        root_path=None,
        subset: str = "train",
        gt2d: bool = True,
        read_confidence: bool = True,
        sample_interval: Optional[int] = None,
        rep: int = 1,
        flip: bool = False,
        cond_3d_prob: float = 0,
        abs_coord: bool = False,
        rot: bool = False,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.root_path = root_path
        self.subset = subset
        self.gt2d = gt2d
        self.read_confidence = read_confidence
        self.sample_interval = sample_interval
        self.flip = flip
        self.cond_3d_prob = cond_3d_prob
        self.abs_coord = abs_coord
        self.rot = rot
        self.rng = rng or np.random.RandomState()
        self.image_name: list = []
        self.camera_param: Optional[np.ndarray] = None

        self.read_data()
        self._check_alignment()

        if self.sample_interval:
            self._sample(self.sample_interval)

        self.rep = rep
        if self.rep > 1:
            print(f"stack dataset {self.rep} times for multi-sample eval")
        self.real_data_len = len(self.db_2d)

    def read_data(self):
        raise NotImplementedError

    def _eval_gt_items(self):
        """GT source of the H36M-pkl-style evaluations: the own `gt_dataset`
        on the test subset (or when `seq5678` forces it); otherwise
        `h36m_test.pkl` from the dataset root. On a non-test subset without
        seq5678 that fallback scores predictions against test-set GT, as the
        reference does: only meaningful when the batch is the test set."""
        gt_items = getattr(self, "gt_dataset", None)
        if (self.subset == "test" and gt_items) or getattr(self, "seq5678", False):
            if not gt_items:
                raise ValueError(
                    "seq5678=True requires gt_dataset to be populated with "
                    "h36m-format GT items")
            return gt_items
        file_path = os.path.join(self.root_path, "h36m_test.pkl")
        print("loading h36m_test.pkl")
        with open(file_path, "rb") as f:
            return pickle.load(f)

    def _check_alignment(self):
        """Every per-frame table a solver reads has the same row count, or
        `arrays()` would pair 2D rows with the wrong intrinsics."""
        n = len(self.db_2d)
        if len(self.db_3d) < n:
            raise AssertionError(
                f"{type(self).__name__}: db_3d has {len(self.db_3d)} rows, db_2d has {n}")
        if self.camera_param is not None and len(self.camera_param) != n:
            raise AssertionError(
                f"{type(self).__name__}: camera_param has {len(self.camera_param)} rows, "
                f"db_2d has {n} — intrinsics misaligned with frames")

    def _strided_fields(self) -> list[str]:
        """Attribute names strided by `_sample`."""
        return ["db_2d", "db_3d", "camera_param", "image_name"]

    def _sample(self, sample_interval: int):
        print(f"{type(self).__name__}({self.subset}): sample dataset every "
              f"{sample_interval} frame")
        for name in self._strided_fields():
            val = getattr(self, name, None)
            if val is not None and len(val):
                setattr(self, name, val[::sample_interval])

    def __len__(self):
        return len(self.db_2d) * self.rep

    def __getitem__(self, idx):
        """(data_2d [j, 3], data_3d [j, 3]); the 2D zero-padded to 3 channels."""
        data_2d = self.db_2d[idx % self.real_data_len]
        data_3d = self.db_3d[idx % self.real_data_len]
        if data_2d.shape[-1] == 2:
            data_2d = np.concatenate((data_2d, np.zeros((len(data_2d), 1), dtype=np.float32)),
                                     axis=-1)
        if self.cond_3d_prob and self.subset == "train":
            if self.rng.rand(1)[0] < self.cond_3d_prob:
                data_2d = data_3d
        if self.flip and self.subset == "train":
            data_3d = self._random_flip(data_3d)
        if self.rot and self.subset == "train":
            data_3d = self._random_rotate(data_3d)
        return data_2d, data_3d

    def _flip_joints(self, data: np.ndarray) -> np.ndarray:
        """x negated and left/right joints swapped on the joint axis (-2)."""
        out = data.copy()
        out[..., 0] *= -1
        out[..., self.left_joints + self.right_joints, :] = \
            out[..., self.right_joints + self.left_joints, :]
        return out

    def _random_flip(self, data, p=0.5):
        if self.rng.rand(1)[0] < p:
            data = self._flip_joints(data)
        return data

    def _random_rotate(self, data, p=0.5):
        from scipy.spatial.transform import Rotation

        if self.rng.rand(1)[0] < p:
            data = Rotation.random(random_state=self.rng).as_matrix().dot(data.T).T
        return data

    def augment_batch(self, batch_3d: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        """The train-time flip and rotation of a [B, j, 3] batch, each row
        independently with p = 0.5 for each (the batched form of
        `__getitem__`'s). Linear, so it commutes with the data scale."""
        if self.subset != "train" or not (self.flip or self.rot):
            return batch_3d
        from scipy.spatial.transform import Rotation

        out = np.asarray(batch_3d).copy()
        n = len(out)
        if self.flip:
            do = rng.rand(n) < 0.5
            out = np.where(do[:, None, None], self._flip_joints(out), out)
        if self.rot:
            do = rng.rand(n) < 0.5
            mats = Rotation.random(n, random_state=rng).as_matrix()
            rotated = np.einsum("nij,nkj->nki", mats.astype(out.dtype), out)
            out = np.where(do[:, None, None], rotated, out)
        return out.astype(batch_3d.dtype, copy=False)

    def augment_batch_cond(self, batch_3d: np.ndarray, cond2d: np.ndarray,
                           rng: np.random.RandomState):
        """The flip of conditional training: x negated and left/right joints
        swapped in the 3D pose AND its 2D condition together (in the ±1 image
        frame of normalize_data an image flip is x negation). The rotation
        has no 2D counterpart without re-projection and is not applied.
        Returns (batch_3d, cond2d)."""
        if self.subset != "train" or not self.flip:
            return batch_3d, cond2d
        out = np.asarray(batch_3d).copy()
        cond = np.asarray(cond2d).copy()
        n = len(out)
        if len(cond) != n:
            raise ValueError(f"augment_batch_cond: {n} poses but {len(cond)} conditions")
        do = rng.rand(n) < 0.5
        out = np.where(do[:, None, None], self._flip_joints(out), out)
        cond = np.where(do[:, None, None], self._flip_joints(cond), cond)
        return (out.astype(batch_3d.dtype, copy=False),
                cond.astype(cond2d.dtype, copy=False))

    def add_noise(self, pose2d, std=5, noise_type="gaussian"):
        """Synthetic 2D noise."""
        if noise_type == "gaussian":
            return pose2d + std * self.rng.randn(*pose2d.shape).astype(np.float32)
        if noise_type == "uniform":
            return pose2d + std * (self.rng.rand(*pose2d.shape).astype(np.float32) - 0.5)
        raise NotImplementedError

    def arrays(self):
        """(cond2d [N, j, 2], conf [N, j] | None, k [N, 3, 3]) for the solver."""
        db = np.asarray(self.db_2d, dtype=np.float32)
        cond = db[..., :2]
        conf = db[..., 2] if db.shape[-1] > 2 else None
        return cond, conf, np.asarray(self.camera_param, dtype=np.float32)

    @staticmethod
    def get_skeleton():
        return H36M_SKELETON
