"""Euler angles and rotation matrices, pytorch3d's "XYZ" convention (port of
``deep3dmap_tpu/core/all3dtrans/rotations.py``): R = R_x @ R_y @ R_z."""
from __future__ import annotations

import torch


def _axis_rot(angle: torch.Tensor, axis: str) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == "X":
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == "Y":
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    elif axis == "Z":
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    else:
        raise ValueError(axis)
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """angles (..., 3) -> (..., 3, 3); R = R_c0 @ R_c1 @ R_c2."""
    Rs = [_axis_rot(angles[..., i], axis) for i, axis in enumerate(convention)]
    return Rs[0] @ Rs[1] @ Rs[2]


def matrix_to_euler_angles(R: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """The inverse of ``euler_angles_to_matrix`` for the XYZ convention."""
    if convention != "XYZ":
        raise NotImplementedError("only XYZ supported")
    ay = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    ax = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    az = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([ax, ay, az], dim=-1)
