"""Rotation representation conversions (quaternion / matrix / euler /
axis-angle / 6D): port of zedo_tpu/ops/rotations.py, the suite the
reference vendors from PyTorch3D.

Batched over leading dimensions, with `where`-based selection instead of
boolean indexing, so the gradients at the branch points stay defined as in
the JAX module. Matrices act on column vectors: p' = R @ p. Full f32: TF32
is off on the card (utils/config.resolve_device).
"""
from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Real-part-first quaternions [..., 4] -> rotation matrices [..., 3, 3].
    Non-unit quaternions are handled by the 2/|q|^2 normalization (IPO never
    normalizes its learned quaternion). Entry e is two_s (x_e y_e + z_e w_e),
    less from 1 on the diagonal: the nine entries in one pass."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    n = -r
    x, y = torch.stack((j, i, i, i, i, j, i, j, i), -1), torch.stack((j, j, k, j, i, k, k, k, i), -1)
    z, w = torch.stack((k, k, j, k, k, i, j, i, j), -1), torch.stack((k, n, r, r, k, n, n, r, j), -1)
    o = two_s[..., None] * (x * y + z * w)
    diagonal = o[..., ::4]
    diagonal.neg_().add_(1.0)
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a| with the sign of b (ignores -0 and NaN, as the reference does)."""
    return torch.where((a < 0) != (b < 0), -a, a)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> real-part-first quaternions [..., 4]:
    of the four candidates, the best-conditioned one (largest |q_i|)."""
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    batch_dim = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(batch_dim + (9,)), -1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)  # [..., 4, 4]
    quat_candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp(min=0.1))
    onehot = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).to(matrix.dtype)
    return (quat_candidates * onehot[..., None]).sum(-2)


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotations about one axis by `angle` [...] -> [..., 3, 3]."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        r_flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        r_flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        r_flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")
    return torch.stack(r_flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    if convention[1] in (convention[0], convention[2]):
        raise ValueError(f"Invalid convention {convention}.")
    for letter in convention:
        if letter not in ("X", "Y", "Z"):
            raise ValueError(f"Invalid letter {letter} in convention string.")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles in radians [..., 3] -> rotation matrices [..., 3, 3]."""
    if euler_angles.dim() == 0 or euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    _check_convention(convention)
    m = [_axis_angle_rotation(c, e) for c, e in zip(convention, torch.unbind(euler_angles, -1))]
    return torch.matmul(torch.matmul(m[0], m[1]), m[2])


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def _index_from_letter(letter: str) -> int:
    return {"X": 0, "Y": 1, "Z": 2}[letter]


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> Euler angles in radians [..., 3]."""
    _check_convention(convention)
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    i0 = _index_from_letter(convention[0])
    i2 = _index_from_letter(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central_angle = torch.asin(matrix[..., i0, i2] * (-1.0 if i0 - i2 in [-1, 2] else 1.0))
    else:
        central_angle = torch.acos(matrix[..., i0, i0])
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central_angle,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


def random_quaternions(generator: torch.Generator, n: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Random unit quaternions with nonnegative real part [n, 4], drawn from
    `generator` (on `device`, default the generator's)."""
    device = generator.device if device is None else device
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    s = (o * o).sum(1)
    return o / _copysign(torch.sqrt(s), o[:, 0])[:, None]


def random_rotations(generator: torch.Generator, n: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Random rotation matrices [n, 3, 3] drawn from `generator`."""
    return quaternion_to_matrix(random_quaternions(generator, n, dtype=dtype, device=device))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Force a nonnegative real part (PyTorch3D's convention)."""
    return torch.where(quaternions[..., 0:1] < 0, -quaternions, quaternions)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


_SMALL_ANGLE = 1e-6


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion [..., 4]; sin(x/2)/x by its Taylor
    series 0.5 - x^2/48 near zero."""
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half_angles = angles * 0.5
    small = angles.abs() < _SMALL_ANGLE
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(small, 0.5 - (angles * angles) / 48.0,
                                      torch.sin(half_angles) / safe_angles)
    return torch.cat([torch.cos(half_angles), axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] -> axis-angle [..., 3], small-angle safe."""
    norms = torch.linalg.vector_norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    small = angles.abs() < _SMALL_ANGLE
    one = torch.ones_like(angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0,
        torch.sin(torch.where(small, one, half_angles)) / torch.where(small, one, angles))
    return quaternions[..., 1:] / sin_half_over_angle


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation [..., 6] -> matrices [..., 3, 3] by
    Gram-Schmidt (Zhou et al., CVPR 2019); the rows are b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Matrices [..., 3, 3] -> their first two rows [..., 6]."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))
