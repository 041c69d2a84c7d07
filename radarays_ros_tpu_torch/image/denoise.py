"""Signal-denoising kernel builders (host-side, static NumPy).

A verbatim copy of radarays_ros_tpu/image/denoise.py (that package cannot be
imported without jax); tests/test_torch_draw.py holds the taps bit-identical.

Counterparts of make_denoiser_{triangular,gaussian,maxwell_boltzmann}
(radar_algorithms.h:267-351). The kernels are small static 1-D arrays built
once per configuration on the host, then splatted around each signal's range
cell on device (image/draw.py) — they are compile-time constants of the
jitted frame, exactly like the uploaded weight buffers of the reference GPU
engine (RadarGPU.cpp:110-134).

Reference quirks preserved:
  * "gaussian" is byte-identical to "triangular" in the reference
    (radar_algorithms.h:310-335) — we keep that equivalence (and document it)
    so images match.
  * Kernels are first normalized to unit sum (radar_algorithms.h:267-281),
    then rescaled at use time so the mode tap has weight 1.0
    (RadarCPU.cpp:83-91); `build_denoiser` returns the rescaled kernel plus
    the integer mode offset.
  * The integer mode is floor(mode_fraction * width) (RadarCPU.cpp:57).

Deviation: mode == 0 would produce 0/0 = NaN in the reference's triangular
builder (radar_algorithms.h:296-297); we define tap 0 as weight 1 instead.
"""

from __future__ import annotations

import numpy as np


def _normalize(k: np.ndarray) -> np.ndarray:
    return k / k.sum()


def _triangular(width: int, mode: int) -> np.ndarray:
    i = np.arange(width, dtype=np.float32)
    if mode > 0:
        up = i / float(mode)
    else:
        up = np.ones_like(i)
    down = 1.0 - (i - float(mode)) / (float(width) - float(mode))
    k = np.where(i <= mode, up, down).astype(np.float32)
    return _normalize(k)


def make_denoiser_triangular(width: int, mode: int) -> np.ndarray:
    """Triangular ramp peaking at `mode` (radar_algorithms.h:283-308)."""
    return _triangular(width, mode)


def make_denoiser_gaussian(width: int, mode: int) -> np.ndarray:
    """Alias of triangular — the reference's 'gaussian' body is identical
    (radar_algorithms.h:310-335)."""
    return _triangular(width, mode)


def maxwell_boltzmann_pdf(mode: float, x: np.ndarray) -> np.ndarray:
    """MB pdf parameterized by its mode (radar_algorithms.h:141-157;
    python oracle scripts/maxwell_boltzmann.py:6-13)."""
    a = mode / np.sqrt(2.0)
    xx = np.square(x)
    return np.sqrt(2.0 / np.pi) * xx * np.exp(-xx / (2.0 * a * a)) / (a ** 3)


def make_denoiser_maxwell_boltzmann(width: int, mode: int) -> np.ndarray:
    """MB-shaped kernel sampled at taps 0..width-1 (radar_algorithms.h:337-351)."""
    i = np.arange(width, dtype=np.float32)
    return _normalize(maxwell_boltzmann_pdf(float(mode), i).astype(np.float32))


_BUILDERS = {
    1: make_denoiser_triangular,
    2: make_denoiser_gaussian,
    3: make_denoiser_maxwell_boltzmann,
}


def build_denoiser(mode_enum: int, width: int, mode_fraction: float):
    """Build the use-time kernel for a signal_denoising enum value.

    Args:
      mode_enum: 0=none, 1=triangular, 2=gaussian, 3=maxwell_boltzmann
        (cfg/RadarModel.cfg:38-44).
      width: kernel width in range cells.
      mode_fraction: kernel mode as a fraction of the width.

    Returns (weights | None, mode_index): weights scaled so the mode tap is
    1.0 (RadarCPU.cpp:83-91); None when denoising is off.
    """
    if mode_enum == 0:
        return None, 0
    mode = int(mode_fraction * width)
    k = _BUILDERS[mode_enum](width, mode)
    return (k / k[mode]).astype(np.float32), mode
