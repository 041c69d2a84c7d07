"""Beam-distribution inspection data (counterpart of
radarays_ros_tpu/viz/beams.py, after the reference's
scripts/radaray_beams.py:63-101).

Samples the four cone distributions D1..D4 and returns, per distribution,
the pitch/yaw offsets, their radial histogram and the fraction of samples
inside the nominal cone (the p_in_cone contract of D3/D4). The samples
come from a torch.Generator seeded per distribution, not from JAX's
threefry, so the reference's data is matched in its statistics, not
sample for sample.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from radarays_ros_tpu_torch.wave.cone import sample_cone_local

_NAMES = ("D1_uniform_radius", "D2_uniform_disk", "D3_normal",
          "D4_sqrt_normal")


def beam_panel(width_deg: float = 8.0, n_samples: int = 5000,
               p_in_cone: float = 0.8, seed: int = 0, n_bins: int = 32,
               device="cuda") -> Dict:
    """Sample all four distributions; return offsets + radial stats:
    {dist_name: {alpha, beta, r_hist, r_edges, frac_in_cone}} with
    alpha/beta the pitch/yaw offsets in radians (the rendered axes of
    radaray_beams.py). Distribution k draws from a generator seeded with
    4 * seed + k."""
    width = float(np.deg2rad(width_deg))
    out = {}
    for dist, name in enumerate(_NAMES):
        gen = torch.Generator(device).manual_seed(4 * seed + dist)
        dirs = sample_cone_local(gen, width, n_samples, dist,
                                 p_in_cone).cpu().numpy()
        # the (alpha, beta) offsets back from the rotated +x directions
        beta = np.arctan2(dirs[:, 1], dirs[:, 0])
        alpha = np.arcsin(np.clip(-dirs[:, 2], -1.0, 1.0)) * -1.0
        r = np.hypot(alpha, beta)
        hist, edges = np.histogram(r, bins=n_bins, range=(0.0, width / 2.0))
        out[name] = {
            "alpha": alpha.tolist(),
            "beta": beta.tolist(),
            "r_hist": hist.tolist(),
            "r_edges": edges.tolist(),
            "frac_in_cone": float(np.mean(r <= width / 2.0)),
        }
    return out
