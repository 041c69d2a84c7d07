"""The poses of the benchmark's trajectories."""

from __future__ import annotations

import numpy as np


def loop_pose(phi, radius: float, height: float) -> np.ndarray:
    """(..., 7) poses [t, q_xyzw] on a circle of `radius` at angle `phi`,
    heading along the circle (counter-clockwise)."""
    phi = np.asarray(phi, np.float64)
    yaw = phi + np.pi / 2
    out = np.zeros(phi.shape + (7,))
    out[..., 0] = radius * np.cos(phi)
    out[..., 1] = radius * np.sin(phi)
    out[..., 2] = height
    out[..., 5] = np.sin(yaw / 2)
    out[..., 6] = np.cos(yaw / 2)
    return out.astype(np.float32)
