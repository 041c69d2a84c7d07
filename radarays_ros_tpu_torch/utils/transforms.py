"""Rigid-transform helpers (counterpart of radarays_ros_tpu/utils/transforms.py).

Poses are 7-vectors [tx, ty, tz, qx, qy, qz, qw], batched over leading axes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x, y, z, w] quaternion -> (..., 3, 3) rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def identity_pose() -> np.ndarray:
    return np.array([0, 0, 0, 0, 0, 0, 1], np.float32)


def make_pose(translation, quat_xyzw=None) -> np.ndarray:
    t = np.asarray(translation, np.float32)
    q = np.asarray(quat_xyzw if quat_xyzw is not None else [0, 0, 0, 1],
                   np.float32)
    return np.concatenate([t, q])


def pose_matrix(pose: torch.Tensor):
    """(..., 7) pose -> (R (..., 3, 3), t (..., 3))."""
    return quat_to_matrix(pose[..., 3:7]), pose[..., 0:3]


def rotz(theta: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 3, 3) rotation about +z."""
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], dim=-2)


def azimuth_angles(n_angles: int, device="cpu") -> torch.Tensor:
    """Beam azimuth per column: theta_i = -2*pi*i / n_angles (the reference
    radar spins clockwise, Radar.cpp:27-32)."""
    i = torch.arange(n_angles, dtype=torch.float32, device=device)
    return -(2.0 * math.pi) * i / n_angles
