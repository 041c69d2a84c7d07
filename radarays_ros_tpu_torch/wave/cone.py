"""Beam cone sampling — the four radial distributions D1..D4 (counterpart of
radarays_ros_tpu/wave/cone.py, after radar_algorithms.cpp:248-385).

Randomness comes from a `torch.Generator`; its stream differs from JAX's, so
the tests compare distributions by their moments. The draws (theta, radial)
are kept apart from the beam width: `cone_local` builds the directions from
explicit draws, differentiably in the width, and the frame entry points take
either the draws or the directions as optional explicit inputs.

    0 (D1): r = u * R                u ~ U(0,1)
    1 (D2): r = sqrt(u) * R
    2 (D3): r = (g / z) * R          g ~ N(0,1), z = sqrt2*erfinv(p_in_cone)
    3 (D4): r = sqrt(|g| / z) * R

The offset (alpha, beta) = (r cos(theta), r sin(theta)), theta ~ U(-pi, pi),
is applied as R = Rz(beta) @ Ry(alpha) to the mean direction.
"""

from __future__ import annotations

import functools
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


def sample_cone_draws(gen: torch.Generator, n_samples: int,
                      sample_dist: int):
    """The random draws of n_samples cone rays, on the generator's device:
    theta ~ U(-pi, pi) (S,) and the radial draw (S,) before it is scaled
    to a radius — u ~ U(0, 1) for D1/D2, g ~ N(0, 1) for D3/D4."""
    if sample_dist not in (0, 1, 2, 3):
        raise ValueError(f"unknown sample_dist {sample_dist} (expected 0..3)")
    device = gen.device
    theta = torch.rand(n_samples, generator=gen, device=device) \
        * (2.0 * math.pi) - math.pi
    draw = torch.rand if sample_dist < 2 else torch.randn
    return theta, draw(n_samples, generator=gen, device=device)


@functools.lru_cache(maxsize=None)
def _z_score(p_in_cone: float) -> float:
    """sqrt(2) * erfinv(p_in_cone), rounded to f32 on the host once."""
    return float(math.sqrt(2.0) * erfinvf(torch.tensor(p_in_cone)))


def _radii(radial, radius, sample_dist: int, p_in_cone):
    # filled in on the device: no host copy a frame, so a CUDA graph can
    # hold it (the f32 value the host computed, as before)
    z = torch.full((), _z_score(float(p_in_cone)), dtype=torch.float32,
                   device=radial.device)
    if sample_dist == 0:
        return radial * radius
    if sample_dist == 1:
        return torch.sqrt(radial) * radius
    if sample_dist == 2:
        return (radial / z) * radius
    if sample_dist == 3:
        return torch.sqrt(torch.abs(radial) / z) * radius
    raise ValueError(f"unknown sample_dist {sample_dist} (expected 0..3)")


def cone_offsets(theta, radial, width, sample_dist: int, p_in_cone):
    """(alpha, beta) pitch/yaw offsets from explicit draws (theta, radial)
    of any shape: a differentiable function of `width` [rad] (the
    reference's sample_cone_offsets after its draws, wave/cone.py:66-74)."""
    radius = torch.as_tensor(width, dtype=torch.float32,
                             device=theta.device) / 2.0
    r = _radii(radial, radius, sample_dist, p_in_cone)
    return r * torch.cos(theta), r * torch.sin(theta)


def cone_dirs(theta, radial, mean_dir, width, sample_dist: int, p_in_cone):
    """(..., 3) directions in a cone around mean_dir from explicit draws."""
    alpha, beta = cone_offsets(theta, radial, width, sample_dist, p_in_cone)
    mean = torch.as_tensor(mean_dir, dtype=torch.float32, device=theta.device)
    return rotate_pitch_yaw(alpha, beta, mean)


def cone_local(theta, radial, width, sample_dist: int, p_in_cone):
    """(..., 3) beam-frame directions around +x from explicit draws."""
    # +x made on the device (no host copy a frame)
    x_axis = torch.eye(3, dtype=torch.float32, device=theta.device)[0]
    return cone_dirs(theta, radial, x_axis, width, sample_dist, p_in_cone)


def sample_cone_offsets(gen: torch.Generator, width, n_samples: int,
                        sample_dist: int, p_in_cone):
    """Draw (alpha, beta) pitch/yaw offsets for n_samples cone rays."""
    return cone_offsets(*sample_cone_draws(gen, n_samples, sample_dist),
                        width, sample_dist, p_in_cone)


def sample_cone_dirs(gen: torch.Generator, mean_dir, width, n_samples: int,
                     sample_dist: int, p_in_cone) -> torch.Tensor:
    """(n_samples, 3) directions in a cone around mean_dir, drawn from `gen`
    on the generator's device (the reference's dirs-only variant,
    radar_algorithms.cpp:296-337); `cone_dirs` is its form with the draws
    given."""
    return cone_dirs(*sample_cone_draws(gen, n_samples, sample_dist),
                     mean_dir, width, sample_dist, p_in_cone)


def sample_cone_local(gen: torch.Generator, width, n_samples: int,
                      sample_dist: int, p_in_cone) -> torch.Tensor:
    """(n_samples, 3) beam-frame directions around +x (radar_algorithms.cpp
    :248-294), drawn from `gen` on the generator's device."""
    return cone_local(*sample_cone_draws(gen, n_samples, sample_dist),
                      width, sample_dist, p_in_cone)


def sample_cone_mean(gen: torch.Generator, mean_dir, width, n_samples: int,
                     sample_dist: int, p_in_cone) -> torch.Tensor:
    """mean_dir followed by n_samples - 1 random cone directions around it
    (the debug beam's sampler, radar_algorithms.cpp:339-385)."""
    mean = torch.as_tensor(mean_dir, dtype=torch.float32, device=gen.device)
    rest = sample_cone_dirs(gen, mean, width, n_samples - 1, sample_dist,
                            p_in_cone)
    return torch.cat([mean[None, :], rest], dim=0)
