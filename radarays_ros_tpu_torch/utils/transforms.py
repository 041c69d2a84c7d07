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


def quat_from_euler(roll, pitch, yaw) -> np.ndarray:
    """Extrinsic-xyz Euler angles -> [x, y, z, w] quaternion (rmagine
    order). Host code in NumPy float64, as the reference's: the trajectory
    builders (io/trajectory.py) need it bit-identical."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.array([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy])


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


def interpolate_poses(pose_a, pose_b, alphas) -> torch.Tensor:
    """Per-azimuth poses for include_motion: the scan-start and scan-end
    poses, one slerped pose per alpha (A,) in [0, 1]. Returns (A, 7) f32 on
    the device of `alphas` (the reference's utils/transforms.py:83)."""
    alphas = torch.as_tensor(alphas, dtype=torch.float32)
    dev = alphas.device
    pose_a = torch.as_tensor(pose_a, dtype=torch.float32, device=dev)
    pose_b = torch.as_tensor(pose_b, dtype=torch.float32, device=dev)
    a = alphas[:, None]
    t = pose_a[None, 0:3] * (1 - a) + pose_b[None, 0:3] * a
    qa, qb = pose_a[3:7], pose_b[3:7]
    dot = torch.sum(qa * qb)
    qb = torch.where(dot < 0, -qb, qb)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = torch.where(use_lerp, 1.0, sin_theta)
    w_a = torch.where(use_lerp, 1.0 - alphas,
                      torch.sin((1.0 - alphas) * theta) / safe)
    w_b = torch.where(use_lerp, alphas, torch.sin(alphas * theta) / safe)
    q = qa[None, :] * w_a[:, None] + qb[None, :] * w_b[:, None]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([t, q], dim=-1)
