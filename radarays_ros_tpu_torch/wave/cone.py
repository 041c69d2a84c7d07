"""Beam cone sampling — the four radial distributions D1..D4 (counterpart of
radarays_ros_tpu/wave/cone.py, after radar_algorithms.cpp:248-385).

Randomness comes from a `torch.Generator`; its stream differs from JAX's, so
the tests compare distributions by their moments, and the frame entry points
take the cone directions as an optional explicit input.

    0 (D1): r = u * R                u ~ U(0,1)
    1 (D2): r = sqrt(u) * R
    2 (D3): r = (g / z) * R          g ~ N(0,1), z = sqrt2*erfinv(p_in_cone)
    3 (D4): r = sqrt(|g| / z) * R

The offset (alpha, beta) = (r cos(theta), r sin(theta)), theta ~ U(-pi, pi),
is applied as R = Rz(beta) @ Ry(alpha) to the mean direction.
"""

from __future__ import annotations

import math

import torch

from radarays_ros_tpu_torch.wave.radar_math import erfinvf


def rotate_pitch_yaw(alpha, beta, v):
    """Apply R = Rz(beta) @ Ry(alpha) to vector(s) v (broadcasting)."""
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x1 = ca * x + sa * z
    y1 = y
    z1 = -sa * x + ca * z
    x2 = cb * x1 - sb * y1
    y2 = sb * x1 + cb * y1
    return torch.stack(torch.broadcast_tensors(x2, y2, z1), dim=-1)


def _sample_radii(gen, n_samples: int, radius, sample_dist: int, p_in_cone,
                  device):
    z = math.sqrt(2.0) * erfinvf(torch.tensor(p_in_cone)).to(device)
    if sample_dist == 0:
        u = torch.rand(n_samples, generator=gen, device=device)
        return u * radius
    if sample_dist == 1:
        u = torch.rand(n_samples, generator=gen, device=device)
        return torch.sqrt(u) * radius
    if sample_dist == 2:
        g = torch.randn(n_samples, generator=gen, device=device)
        return (g / z) * radius
    if sample_dist == 3:
        g = torch.randn(n_samples, generator=gen, device=device)
        return torch.sqrt(torch.abs(g) / z) * radius
    raise ValueError(f"unknown sample_dist {sample_dist} (expected 0..3)")


def sample_cone_local(gen: torch.Generator, width, n_samples: int,
                      sample_dist: int, p_in_cone) -> torch.Tensor:
    """(n_samples, 3) beam-frame directions around +x (radar_algorithms.cpp
    :248-294), drawn from `gen` on the generator's device."""
    device = gen.device
    theta = torch.rand(n_samples, generator=gen, device=device) \
        * (2.0 * math.pi) - math.pi
    radius = torch.as_tensor(width, dtype=torch.float32, device=device) / 2.0
    r = _sample_radii(gen, n_samples, radius, sample_dist, p_in_cone, device)
    mean = torch.tensor([1.0, 0.0, 0.0], device=device)
    return rotate_pitch_yaw(r * torch.cos(theta), r * torch.sin(theta), mean)
