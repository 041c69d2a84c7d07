"""Signal drawing: (time, strength) pairs -> polar range/azimuth image
(counterpart of radarays_ros_tpu/image/draw.py, after RadarCPU.cpp:402-542).

  * range cell = floor((0.3 * t / 2) / resolution); out-of-range signals
    are dropped (RadarCPU.cpp:410-413);
  * denoise mode: point-bin, then correlate with the static kernel — the
    reference's per-signal tap splat is linear, so the two are the same;
    range cell 0 is never written (the glob_id > 0 guard, :423-424);
  * no-denoise mode: per-cell max (RadarCPU.cpp:434-448);
  * ambient noise and per-column normalization follow RadarCPU.cpp:453-542.

Binning runs through the K5 wrapper (image/cuda_draw.py), or its plain
version directly with method="plain"; both are differentiable w.r.t. the
strengths.
"""

from __future__ import annotations

import numpy as np
import torch

from radarays_ros_tpu_torch.image.cuda_draw import _bin_plain, bin_signals
from radarays_ros_tpu_torch.image.perlin import perlin_affine_rows


def bin_cells(times, resolution):
    """Range cell index for signal times: (0.3 [m/ns] * t / 2) / resolution."""
    signal_dist = 0.3 * times / 2.0
    return (signal_dist / resolution).to(torch.int32)


def draw_signals(times, strengths, valid, *, n_cells: int, resolution,
                 denoise_weights=None, denoise_mode: int = 0,
                 method: str = "auto"):
    """Draw per-row signal lists into an (A, n_cells) float image.

    times/strengths/valid (A, N); denoise_weights: static (W,) kernel (mode
    tap 1.0) or None for max-combine. method: "auto" (the K5 wrapper: the
    kernel on CUDA tensors) or "plain" (its plain torch version). Returns
    (image (A, n_cells), max_val (A,)), max_val taken before any energy
    scaling.
    """
    if method not in ("auto", "plain"):
        raise ValueError(f"unknown draw method {method!r}")
    binner = _bin_plain if method == "plain" else bin_signals
    cell = bin_cells(times, resolution)
    ok = valid & (cell >= 0) & (cell < n_cells)
    cell = torch.where(ok, cell, n_cells).to(torch.int32).contiguous()
    if denoise_weights is not None:
        img = binner(cell, torch.where(ok, strengths, 0.0).contiguous(),
                     n_cells=n_cells, combine="sum",
                     weights=np.asarray(denoise_weights, np.float32),
                     w_mode=denoise_mode)
        # the reference never writes range cell 0 here; out of place, so
        # autograd never sees an in-place edit of the binning's output
        img = torch.nn.functional.pad(img[:, 1:], (1, 0))
    else:
        img = binner(cell, torch.where(ok, strengths, -torch.inf).contiguous(),
                     n_cells=n_cells, combine="max")
    return img, img.amax(dim=-1)


def apply_ambient_noise(img, max_val, cols, *, mode: int, resolution,
                        at_signal_0, at_signal_1, energy_max, energy_min,
                        energy_loss, perlin_scale_low=0.05,
                        perlin_scale_high=0.2, perlin_p_low=0.9,
                        random_begin=None, uniform=None):
    """Add signal-adaptive ambient noise to an (A, n_cells) image.

    `img` is already scaled by energy_max while `max_val` is the pre-scaling
    column max (the reference's asymmetry, RadarCPU.cpp:453-533).
    mode: 0 none, 1 uniform — `uniform` (A, n_cells) in [0, 1) — or 2
    two-octave Perlin — `random_begin` (A,) integer row offsets in
    [0, 1000). cols: (A,) image column per row (the Perlin y coordinate).
    """
    if mode == 0:
        return img
    n_cells = img.shape[-1]
    i = torch.arange(n_cells, dtype=torch.float32, device=img.device)[None, :]
    if mode == 1:
        p = uniform
    else:
        y = cols.to(torch.float32)
        p1 = perlin_affine_rows(random_begin, y * perlin_scale_low,
                                perlin_scale_low, n_cells)
        p2 = perlin_affine_rows(random_begin, y * perlin_scale_high,
                                perlin_scale_high, n_cells)
        p = perlin_p_low * p1 + (1.0 - perlin_p_low) * p2

    amp = max_val[..., None]
    safe_amp = torch.where(amp > 0.0, amp, 1.0)
    signal_frac = 1.0 - img / safe_amp
    sf2 = signal_frac * signal_frac
    signal_4 = sf2 * sf2
    noise_amp = signal_4 * (amp * at_signal_0) \
        + (1.0 - signal_4) * (amp * at_signal_1)

    x = (i + 0.5) * resolution
    noise_e_max = amp * energy_max
    noise_e_min = amp * energy_min
    y_noise = noise_amp * p
    y_noise = y_noise + (noise_e_max - noise_e_min) \
        * torch.exp(-energy_loss * x) + noise_e_min
    return img + torch.abs(y_noise)


def normalize_to_u8(img, max_val, signal_max):
    """Per-column scale to signal_max/max_val, saturate to uint8
    (RadarCPU.cpp:533-542); columns without signal come out all zero."""
    pos = max_val > 0.0
    scale = torch.where(pos, signal_max / torch.where(pos, max_val, 1.0), 0.0)
    out = img * scale[..., None]
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
