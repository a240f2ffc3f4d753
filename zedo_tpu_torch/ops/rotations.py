"""Rotation conversions (port of zedo_tpu/ops/rotations.py; only what the
zero-shot solve runs so far)."""
from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Real-part-first quaternions [..., 4] -> rotation matrices [..., 3, 3].
    Non-unit quaternions are handled by the 2/|q|^2 normalization (IPO never
    normalizes its learned quaternion)."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack((
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ), dim=-1)
    return o.reshape(quaternions.shape[:-1] + (3, 3))
