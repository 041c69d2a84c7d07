"""BRDF / Fresnel curve explorer data (counterpart of
radarays_ros_tpu/viz/brdf.py, after the reference's
scripts/radarays_snell_fresnel_brdf.py).

Sweeps the incidence angle and returns the back-reflection shader's
response, and the reflectance/transmittance split of a velocity pair, as
lists for plotting or asserting, through the port's own wave/fresnel.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from radarays_ros_tpu_torch.wave.fresnel import (back_reflection_shader,
                                                 fresnel_split)


def brdf_curve(ambient: float, diffuse: float, specular: float,
               n_points: int = 181, device="cuda") -> Dict:
    """Back-reflection energy vs incidence angle (the reference's
    A + B*cos^C polynomial with the material call-site convention)."""
    angles = np.linspace(0.0, np.pi / 2.0, n_points)
    energy = back_reflection_shader(
        torch.as_tensor(angles, dtype=torch.float32, device=device), 1.0,
        diffuse=ambient, specular_fac=diffuse, specular_exp=specular)
    return {"angle_rad": angles.tolist(),
            "energy": energy.cpu().numpy().tolist()}


def fresnel_curve(v1: float, v2: float, polarization: float = 0.5,
                  n_points: int = 181, device="cuda") -> Dict:
    """Reff/Teff and refraction angle vs incidence angle for a velocity
    pair: the incidence direction swept in the xz-plane against an
    upward-facing surface."""
    angles = np.linspace(0.0, np.pi / 2.0 - 1e-3, n_points).astype(np.float32)
    d = np.stack([np.sin(angles), np.zeros_like(angles), -np.cos(angles)], -1)
    n = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), d.shape)

    def full(v):
        return torch.full((n_points,), v, dtype=torch.float32, device=device)

    res = fresnel_split(
        torch.as_tensor(np.ascontiguousarray(n), device=device),
        torch.as_tensor(d, device=device), full(1.0), full(polarization),
        full(v1), full(v2))
    refr = res.refraction_dir.cpu().numpy()
    refr_angle = np.degrees(np.arctan2(np.abs(refr[:, 0]),
                                       np.maximum(-refr[:, 2], 1e-12)))
    transmits = np.sum(refr * refr, axis=-1) > 0.25
    return {
        "angle_rad": angles.tolist(),
        "reflectance": res.reflection_energy.cpu().numpy().tolist(),
        "transmittance": res.refraction_energy.cpu().numpy().tolist(),
        "refraction_angle_deg": np.where(transmits, refr_angle,
                                         np.nan).tolist(),
        "total_internal_reflection": (~transmits).tolist(),
    }
