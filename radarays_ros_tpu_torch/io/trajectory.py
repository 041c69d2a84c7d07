"""Trajectory replay: the TF/bag layer of the reference as explicit data
(counterpart of radarays_ros_tpu/io/trajectory.py; NumPy, bit-identical).

The reference takes sensor poses from ROS TF at simulation time, with
last-pose extrapolation when the lookup fails (Radar.cpp:43-186) and a
per-azimuth re-fetch for motion distortion (include_motion,
RadarCPU.cpp:190-196); its synced mode simulates at the stamps of a real
radar topic (radar_simulator.cpp:83-96). Here a `Trajectory` is a
time-indexed pose table (TUM text: `stamp tx ty tz qx qy qz qw` per line):

  * `pose_at(stamp)`      — slerp-interpolated pose, extrapolated linearly
                            in translation beyond the ends;
  * `poses_for_scan(...)` — one pose per azimuth column over a scan;
  * `stamps`              — the sync schedule of the synced mode.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def _slerp(qa: np.ndarray, qb: np.ndarray, alpha) -> np.ndarray:
    """Batched numpy slerp; qa/qb (..., 4) xyzw, alpha (...,) in [0,1]."""
    alpha = np.asarray(alpha, np.float64)[..., None]
    dot = np.sum(qa * qb, axis=-1, keepdims=True)
    qb = np.where(dot < 0, -qb, qb)
    dot = np.abs(np.clip(dot, -1.0, 1.0))
    theta = np.arccos(dot)
    sin_theta = np.sin(theta)
    small = sin_theta < 1e-6
    safe = np.where(small, 1.0, sin_theta)
    w_a = np.where(small, 1.0 - alpha, np.sin((1.0 - alpha) * theta) / safe)
    w_b = np.where(small, alpha, np.sin(alpha * theta) / safe)
    q = w_a * qa + w_b * qb
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class Trajectory:
    """Time-indexed pose table; poses are (7,) [t, q_xyzw] map<-sensor."""

    def __init__(self, stamps: np.ndarray, poses: np.ndarray):
        stamps = np.asarray(stamps, np.float64)
        poses = np.asarray(poses, np.float32)
        if poses.shape != (stamps.shape[0], 7):
            raise ValueError(f"poses must be (N, 7), got {poses.shape}")
        if stamps.shape[0] < 1:
            raise ValueError("empty trajectory")
        order = np.argsort(stamps, kind="stable")
        self.stamps = stamps[order]
        self.poses = poses[order]

    # ------------------------------------------------------------ io

    @staticmethod
    def load_tum(path) -> "Trajectory":
        """Load a TUM-format trajectory (`stamp tx ty tz qx qy qz qw`)."""
        rows = []
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) != 8:
                raise ValueError(f"{path}: expected 8 columns, got "
                                 f"{len(vals)}")
            rows.append(vals)
        arr = np.asarray(rows, np.float64)
        return Trajectory(arr[:, 0], arr[:, 1:8].astype(np.float32))

    def save_tum(self, path) -> None:
        with open(path, "w") as f:
            f.write("# stamp tx ty tz qx qy qz qw\n")
            for s, p in zip(self.stamps, self.poses):
                f.write(f"{s:.9f} " + " ".join(f"{v:.6f}" for v in p) + "\n")

    # ------------------------------------------------------------ query

    def __len__(self) -> int:
        return self.stamps.shape[0]

    def pose_at(self, stamp: float) -> np.ndarray:
        """Interpolated pose at `stamp`; beyond the ends the translation
        extrapolates linearly from the two nearest poses (the reference's
        Tsm_last + delta fallback, Radar.cpp:102-121)."""
        return self.poses_at(np.asarray([stamp]))[0]

    def poses_at(self, stamps: Sequence[float]) -> np.ndarray:
        """Vectorized pose_at: (K,) stamps -> (K, 7)."""
        s = np.asarray(stamps, np.float64)
        if len(self) == 1:
            return np.broadcast_to(self.poses[0], (s.shape[0], 7)).copy()
        hi = np.clip(np.searchsorted(self.stamps, s), 1, len(self) - 1)
        lo = hi - 1
        t0, t1 = self.stamps[lo], self.stamps[hi]
        alpha = (s - t0) / np.maximum(t1 - t0, 1e-12)
        # translation extrapolates; rotation clamps (slerp alpha in [0, 1])
        trans = self.poses[lo, 0:3] + (self.poses[hi, 0:3]
                                       - self.poses[lo, 0:3]) \
            * alpha[:, None].astype(np.float32)
        q = _slerp(self.poses[lo, 3:7].astype(np.float64),
                   self.poses[hi, 3:7].astype(np.float64),
                   np.clip(alpha, 0.0, 1.0))
        return np.concatenate([trans, q.astype(np.float32)], axis=-1)

    def poses_for_scan(self, stamp: float, scan_duration: float,
                       n_angles: int) -> np.ndarray:
        """(n_angles, 7) per-azimuth poses across one scan (include_motion):
        column a at stamp + a/n_angles * scan_duration (the reference's
        per-azimuth TF fetch, RadarCPU.cpp:190-196)."""
        offs = np.arange(n_angles, dtype=np.float64) / n_angles \
            * scan_duration
        return self.poses_at(stamp + offs)

    # ------------------------------------------------------------ builders

    @staticmethod
    def circular(radius: float, n: int, period: float,
                 z: float = 0.0) -> "Trajectory":
        """Synthetic circular drive (testing / demos)."""
        from radarays_ros_tpu_torch.utils.transforms import quat_from_euler

        ts = np.linspace(0.0, period, n, endpoint=False)
        ang = 2 * np.pi * ts / period
        poses = np.zeros((n, 7), np.float32)
        poses[:, 0] = radius * np.cos(ang)
        poses[:, 1] = radius * np.sin(ang)
        poses[:, 2] = z
        for i, a in enumerate(ang):
            poses[i, 3:7] = quat_from_euler(0.0, 0.0, a + np.pi / 2)
        return Trajectory(ts, poses)
