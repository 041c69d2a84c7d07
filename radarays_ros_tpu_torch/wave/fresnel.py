"""Snell/Fresnel wave splitting and the back-reflection shaders (counterpart of
radarays_ros_tpu/wave/fresnel.py, after radar_algorithms.h:55-187).

Branchless: every branch of the reference's scalar C++ is a torch.where, so
the functions map over any wave batch. Reference conventions kept: indices
n1 = v2, n2 = v1 (radar_algorithms.h:62-63); mirror reflection
d - 2 (n.d) n; Snell with the TIR limit asin(n2/n1) and the normal flipped
toward the incoming side; rs/rp special cases at normal (i + r < 1e-4) and
grazing (i + r > pi - 1e-4) incidence; Reff = pol Rs + (1 - pol) Rp,
Teff = 1 - Reff. acos/sqrt inputs and the shader's cosine are clamped.

Gradients: where an acos input reaches +-1 or a sqrt input reaches 0, the
derivative is infinite; a lane whose cotangent is 0 (a dead wave, an
unselected branch) would turn 0 * inf into NaN and poison every parameter
gradient. There the input is detached, so no gradient flows through that
point and the values are unchanged. (The reference's gradient is NaN in
those cases, and also under total internal reflection, ROADMAP.md
section 3.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS_ANGLE = 1e-4  # special-case window of radar_algorithms.h:111


def _clamped_acos(x):
    """arccos of x clamped to [-1, 1], with no gradient at +-1."""
    c = torch.clamp(x, -1.0, 1.0)
    return torch.arccos(torch.where(c.abs() < 1.0, c, c.detach()))


def _clamped_sqrt(x):
    """sqrt of x clamped to >= 0, with no gradient at 0."""
    c = torch.clamp_min(x, 0.0)
    return torch.sqrt(torch.where(c > 0.0, c, c.detach()))


def get_incidence_angle(surface_normal, incidence_dir):
    """Angle between the reversed incidence direction and the normal
    (radar_algorithms.h:25-31)."""
    return _clamped_acos(torch.sum(-incidence_dir * surface_normal, dim=-1))


class FresnelResult(NamedTuple):
    reflection_dir: torch.Tensor     # (..., 3)
    refraction_dir: torch.Tensor     # (..., 3) — zeros when no transmission
    reflection_energy: torch.Tensor  # (...,) Reff * E
    refraction_energy: torch.Tensor  # (...,) Teff * E
    incidence_angle: torch.Tensor    # (...,) radians


def fresnel_split(surface_normal, incidence_dir, energy, polarization, v1, v2
                  ) -> FresnelResult:
    """Split an incident wave into reflection + refraction (Snell + Fresnel).

    surface_normal/incidence_dir (..., 3); energy, polarization, v1 (speed in
    the incidence medium) and v2 (speed in the refraction medium) (...,).
    """
    n = surface_normal
    d = incidence_dir
    n1 = torch.as_tensor(v2, dtype=torch.float32)
    n2 = torch.as_tensor(v1, dtype=torch.float32)

    n_dot_d = torch.sum(n * d, dim=-1)
    incidence_angle = _clamped_acos(-n_dot_d)

    reflection_dir = d - 2.0 * n_dot_d[..., None] * n

    one = torch.ones_like(n1)
    safe_n1 = torch.where(n1 > 0.0, n1, one)
    safe_n2 = torch.where(n2 > 0.0, n2, one)
    n21 = n2 / safe_n1
    angle_limit = torch.where(torch.abs(n21) <= 1.0,
                              torch.arcsin(torch.clamp(n21, -1.0, 1.0)),
                              torch.full_like(n21, 100.0))
    n_oriented = torch.where((n_dot_d > 0.0)[..., None], -n, n)
    n12 = n1 / safe_n2
    c = torch.cos(incidence_angle)
    radicand = 1.0 - n12 * n12 * (1.0 - c * c)
    root = _clamped_sqrt(radicand)
    refr_candidate = d * n12[..., None] + n_oriented * (n12 * c - root)[..., None]

    transmits = (n1 > 0.0) & (incidence_angle <= angle_limit) & (n2 > 0.0)
    refraction_dir = torch.where(transmits[..., None], refr_candidate,
                                 torch.zeros_like(refr_candidate))

    # the reference measures the refraction angle against the normal it
    # used for construction, flipped only inside the angle-limit branch
    flipped = (n1 > 0.0) & (incidence_angle <= angle_limit)
    n_for_angle = torch.where(flipped[..., None], n_oriented, n)
    refraction_angle = _clamped_acos(
        torch.sum(refraction_dir * (-n_for_angle), dim=-1))

    s = incidence_angle + refraction_angle
    sin_s = torch.sin(s)
    tan_s = torch.tan(s)
    safe = torch.abs(sin_s) > 1e-12
    rs_gen = torch.where(
        safe, -torch.sin(incidence_angle - refraction_angle)
        / torch.where(safe, sin_s, torch.ones_like(sin_s)),
        torch.ones_like(sin_s))
    safe_t = torch.abs(tan_s) > 1e-12
    rp_gen = torch.where(
        safe_t, torch.tan(incidence_angle - refraction_angle)
        / torch.where(safe_t, tan_s, torch.ones_like(tan_s)),
        torch.ones_like(tan_s))

    nsum = n1 + n2
    rs_normal = (n1 - n2) / torch.where(torch.abs(nsum) > 1e-12, nsum,
                                        torch.ones_like(nsum))

    near_normal = s < _EPS_ANGLE
    near_grazing = s > math.pi - _EPS_ANGLE
    ones = torch.ones_like(rs_gen)
    rs = torch.where(near_normal, rs_normal,
                     torch.where(near_grazing, ones, rs_gen))
    rp = torch.where(near_normal, rs_normal,
                     torch.where(near_grazing, ones, rp_gen))

    reff = torch.clamp(polarization * (rs * rs)
                       + (1.0 - polarization) * (rp * rp), 0.0, 1.0)
    teff = 1.0 - reff
    return FresnelResult(reflection_dir=reflection_dir,
                         refraction_dir=refraction_dir,
                         reflection_energy=reff * energy,
                         refraction_energy=teff * energy,
                         incidence_angle=incidence_angle)


def back_reflection_shader(incidence_angle, energy, diffuse, specular_fac,
                           specular_exp):
    """(diffuse + specular_fac * max(cos(angle), 0)^specular_exp) * energy
    (radar_algorithms.h:168-187)."""
    c = torch.clamp_min(torch.cos(incidence_angle), 0.0)
    return (diffuse + specular_fac * torch.pow(c, specular_exp)) * energy


def cook_torrance_shader(incidence_angle, energy, roughness, fresnel_f0,
                         k_diffuse):
    """Monostatic Cook-Torrance back-reflection (Beckmann D, G = min(1,
    2 cos^2), Schlick F): k_d cos + (1 - k_d) D G F / (pi cos)."""
    c = torch.clamp(torch.cos(incidence_angle), 1e-4, 1.0)
    m = torch.clamp_min(torch.as_tensor(roughness), 1e-3)
    c2 = c * c
    t2 = (1.0 - c2) / c2
    d = torch.exp(-t2 / (m * m)) / (math.pi * m * m * c2 * c2)
    g = torch.clamp_max(2.0 * c2, 1.0)
    f = fresnel_f0 + (1.0 - fresnel_f0) * torch.pow(1.0 - c, 5.0)
    spec = d * g * f / (math.pi * c)
    return (k_diffuse * c + (1.0 - k_diffuse) * spec) * energy
