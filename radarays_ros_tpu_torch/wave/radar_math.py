"""Scalar radar math (counterpart of radarays_ros_tpu/wave/radar_math.py,
after radar_math.h): the speed of light, the inverse error function of the
cone sampling and the normal quantile."""

from __future__ import annotations

import torch

# Speed of light in vacuum [m/s] (radar_math.h:10); the wave model works in
# m/ns, where air velocity is 0.3.
M_C = 2.99792458e8

_TAIL = (2.93243101e-8, 1.22150334e-6, 2.84108955e-5, 3.93552968e-4,
         3.02698812e-3, 4.83185798e-3, -2.64646143e-1, 8.40016484e-1)
_CORE = (1.43285448e-7, 1.22774793e-6, 1.12963626e-7, -5.61530760e-5,
         -1.47697632e-4, 2.31468678e-3, 1.15392581e-2, -2.32015476e-1,
         8.86226892e-1)


def erfinvf(a) -> torch.Tensor:
    """Single-precision polynomial erf^-1 of radar_math.h:13-44 (two
    branches on |log(1 - a^2)|, selected at 6.125)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    t = 1.0 - a * a
    t = torch.log(torch.clamp_min(t, torch.finfo(torch.float32).tiny))

    p_tail = torch.full_like(t, 3.03697567e-10)
    for c in _TAIL:
        p_tail = p_tail * t + c
    p_core = torch.full_like(t, 5.43877832e-9)
    for c in _CORE:
        p_core = p_core * t + c
    return a * torch.where(torch.abs(t) > 6.125, p_tail, p_core)


def quantile(p) -> torch.Tensor:
    """Standard-normal quantile sqrt(2) * erfinv(2p - 1) in f32
    (radar_math.h:46-49): the z-score within which a fraction p of normal
    samples falls."""
    p = torch.as_tensor(p, dtype=torch.float32)
    two = torch.full((), 2.0, device=p.device)    # no host copy a call
    return torch.sqrt(two) * erfinvf(2.0 * p - 1.0)
