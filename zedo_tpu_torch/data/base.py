"""Shared dataset skeleton: the port's copy of the evaluation half of
zedo_tpu/data/base.py (numpy only).

Subclasses implement `read_data` (format-faithful readers) and
`eval`/`eval_multi` on top of data/evaluation.py. The train-time
augmentations (`__getitem__`'s flips and rotations, `augment_batch*`,
`add_noise`) wait for the training port (ROADMAP.md Queue 1, item 13).

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
    """Common ctor wiring and the tensors a solver and an evaluation read.

    Subclasses set db_2d [N, j, 2|3], db_3d [N, j, 3], camera_param [N, 3, 3]
    (and whatever extras) in `read_data`, called by `__init__`. The JAX
    package's training arguments (`rep`, `flip`, `cond_3d_prob`, `rot`,
    `rng`) come with the augmentations."""

    def __init__(
        self,
        root_path=None,
        subset: str = "train",
        gt2d: bool = True,
        read_confidence: bool = True,
        sample_interval: Optional[int] = None,
        abs_coord: bool = False,
    ):
        self.root_path = root_path
        self.subset = subset
        self.gt2d = gt2d
        self.read_confidence = read_confidence
        self.sample_interval = sample_interval
        self.abs_coord = abs_coord
        self.image_name: list = []
        self.camera_param: Optional[np.ndarray] = None

        self.read_data()
        self._check_alignment()

        if self.sample_interval:
            self._sample(self.sample_interval)

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
        return len(self.db_2d)

    def arrays(self):
        """(cond2d [N, j, 2], conf [N, j] | None, k [N, 3, 3]) for the solver."""
        db = np.asarray(self.db_2d, dtype=np.float32)
        cond = db[..., :2]
        conf = db[..., 2] if db.shape[-1] > 2 else None
        return cond, conf, np.asarray(self.camera_param, dtype=np.float32)

    @staticmethod
    def get_skeleton():
        return H36M_SKELETON
