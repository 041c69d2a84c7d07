"""Paper-style cartesian rendering + imaging statistics of polar frames
(counterpart of radarays_ros_tpu/viz/cartesian.py; NumPy, bit-identical).

The reference's published result view (dat/kaist02_radarays_papercolor.png,
README.md:11-14) shows radar frames as top-down cartesian images: range cell
r at azimuth column a maps to the point (r cos th_a, r sin th_a) with
th_a = -2*pi*a/A (the rotation convention of Radar.cpp:27-32 /
utils/transforms.py:azimuth_angles). This module renders that view from a
polar frame and computes the imaging statistics used to compare a simulated
frame against a real (or published) one when no raw bag data is available:

  * noise-floor histogram — the intensity distribution of the below-
    threshold cells (the ambient-noise model's fingerprint);
  * return density vs range — fraction of cells above threshold per range
    annulus (how hits thin out with distance);
  * per-column dynamic range — strongest return minus the column's median
    (the contrast the per-column signal_max/max_val normalization produces,
    RadarCPU.cpp:533-542).

All NumPy, no device involvement — this is an offline analysis/visualization
surface (the closest honest substitute for the reference's
eval_real_to_sim.launch bag replay, which needs unobtainable Navtech data).
"""

from __future__ import annotations

import numpy as np


def polar_to_cartesian(img: np.ndarray, *, size: int = 800,
                       max_cell: int | None = None, scroll: int = 0,
                       bilinear: bool = True) -> np.ndarray:
    """Render a (n_cells, A) polar frame as a (size, size) top-down view.

    Pixel (i, j) maps to metric-free plane coords centered at the sensor;
    the outer edge of the view is range cell `max_cell` (default: all
    cells). Azimuth convention matches polar_to_points (io/image_io.py):
    column a lies at angle -2*pi*((a - scroll) % A)/A. x points up
    (forward), y left — the view the paper figure uses.
    """
    img = np.asarray(img)
    n_cells, A = img.shape
    rmax = float(max_cell if max_cell is not None else n_cells - 1)
    half = (size - 1) / 2.0
    ys, xs = np.mgrid[0:size, 0:size]
    # view axes: up = +x (forward), left = +y
    x = (half - ys) / half * rmax
    y = (half - xs) / half * rmax
    r = np.hypot(x, y)
    ang = np.arctan2(y, x)                       # (-pi, pi]
    a = (-ang) % (2.0 * np.pi) / (2.0 * np.pi) * A
    a = (a + scroll) % A
    inside = r <= rmax

    if bilinear:
        r0 = np.clip(np.floor(r).astype(np.int64), 0, n_cells - 1)
        r1 = np.minimum(r0 + 1, n_cells - 1)
        fr = np.clip(r - r0, 0.0, 1.0)
        a0 = np.floor(a).astype(np.int64) % A
        a1 = (a0 + 1) % A
        fa = a - np.floor(a)
        v = ((1 - fr) * ((1 - fa) * img[r0, a0] + fa * img[r0, a1])
             + fr * ((1 - fa) * img[r1, a0] + fa * img[r1, a1]))
    else:
        r0 = np.clip(np.round(r).astype(np.int64), 0, n_cells - 1)
        a0 = np.round(a).astype(np.int64) % A
        v = img[r0, a0].astype(np.float64)
    out = np.where(inside, v, 0.0)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


_PAPER_STOPS = np.array([
    # the dark-to-bright colormap of the published figure: black body-ish
    [0.00, 0.00, 0.00],
    [0.10, 0.03, 0.25],
    [0.45, 0.05, 0.48],
    [0.85, 0.25, 0.30],
    [0.98, 0.65, 0.10],
    [1.00, 1.00, 0.75],
], np.float64)


def stretch_contrast(img: np.ndarray, *, percentile: float = 99.5,
                     gamma: float = 0.7) -> np.ndarray:
    """Display normalization for paper-style views: scale the given
    percentile to full white, then apply a gamma lift (the published
    figure's panels are contrast-stretched screenshots, not raw mono8)."""
    g = np.asarray(img, np.float64)
    hi = np.percentile(g[g > 0], percentile) if np.any(g > 0) else 1.0
    t = np.clip(g / max(hi, 1e-6), 0.0, 1.0) ** gamma
    return np.clip(np.round(t * 255.0), 0, 255).astype(np.uint8)


def colorize_papercolor(gray: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) uint8 with an inferno-like colormap (the
    palette family of the published figure)."""
    t = np.asarray(gray, np.float64) / 255.0
    n = _PAPER_STOPS.shape[0]
    pos = t * (n - 1)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 2)
    f = (pos - i0)[..., None]
    rgb = _PAPER_STOPS[i0] * (1 - f) + _PAPER_STOPS[i0 + 1] * f
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def imaging_stats(img: np.ndarray, *, noise_threshold: int = 32,
                  n_range_bins: int = 32, n_hist_bins: int = 32) -> dict:
    """Comparable imaging statistics of one polar frame (see module doc)."""
    img = np.asarray(img, np.float64)
    n_cells, A = img.shape
    below = img[img < noise_threshold]
    hist, edges = np.histogram(below, bins=n_hist_bins,
                               range=(0, noise_threshold), density=True)
    cells = np.arange(n_cells)
    rb = np.minimum((cells * n_range_bins) // n_cells, n_range_bins - 1)
    above = img >= noise_threshold
    density = np.array([
        above[rb == b].mean() if np.any(rb == b) else 0.0
        for b in range(n_range_bins)
    ])
    dyn = img.max(axis=0) - np.median(img, axis=0)        # per column
    return {
        "noise_floor_hist": hist.tolist(),
        "noise_floor_edges": edges.tolist(),
        "noise_floor_mean": float(below.mean()) if below.size else 0.0,
        "noise_floor_std": float(below.std()) if below.size else 0.0,
        "return_density_vs_range": density.tolist(),
        "return_fraction": float(above.mean()),
        "dynamic_range_per_column_mean": float(dyn.mean()),
        "dynamic_range_per_column_std": float(dyn.std()),
        "noise_threshold": noise_threshold,
    }


def cartesian_stats(gray: np.ndarray, *, center=None, radius=None,
                    noise_threshold: int = 32, n_range_bins: int = 32,
                    n_hist_bins: int = 32) -> dict:
    """imaging_stats for a CARTESIAN radar view (e.g. the published figure
    dat/kaist02_radarays_papercolor.png, or polar_to_cartesian output):
    range = distance from `center` (default image center), bounded by
    `radius` (default: the largest inscribed circle). Produces the same
    keys as imaging_stats so compare_imaging_stats works across the two.
    """
    g = np.asarray(gray, np.float64)
    H, W = g.shape
    cy, cx = center if center is not None else ((H - 1) / 2.0, (W - 1) / 2.0)
    rad = float(radius) if radius is not None else min(cy, cx, H - 1 - cy,
                                                       W - 1 - cx)
    ys, xs = np.mgrid[0:H, 0:W]
    r = np.hypot(ys - cy, xs - cx)
    inside = r <= rad
    v = g[inside]
    rr = r[inside]
    below = v[v < noise_threshold]
    hist, edges = np.histogram(below, bins=n_hist_bins,
                               range=(0, noise_threshold), density=True)
    rb = np.minimum((rr * n_range_bins / rad).astype(np.int64),
                    n_range_bins - 1)
    above = v >= noise_threshold
    density = np.array([
        above[rb == b].mean() if np.any(rb == b) else 0.0
        for b in range(n_range_bins)
    ])
    # "columns" of a cartesian view: azimuth sectors around the center
    ang = np.arctan2(ys - cy, xs - cx)[inside]
    sector = ((ang + np.pi) / (2 * np.pi) * 64).astype(np.int64) % 64
    dyn = np.array([
        v[sector == s].max() - np.median(v[sector == s])
        if np.any(sector == s) else 0.0 for s in range(64)
    ])
    return {
        "noise_floor_hist": hist.tolist(),
        "noise_floor_edges": edges.tolist(),
        "noise_floor_mean": float(below.mean()) if below.size else 0.0,
        "noise_floor_std": float(below.std()) if below.size else 0.0,
        "return_density_vs_range": density.tolist(),
        "return_fraction": float(above.mean()),
        "dynamic_range_per_column_mean": float(dyn.mean()),
        "dynamic_range_per_column_std": float(dyn.std()),
        "noise_threshold": noise_threshold,
    }


def compare_imaging_stats(a: dict, b: dict) -> dict:
    """Distances between two imaging_stats dicts: total-variation distance
    of the noise-floor histograms, L1 gap of the range-density curves and
    the dynamic-range deltas. Small numbers = statistically similar frames.
    """
    ha = np.asarray(a["noise_floor_hist"], np.float64)
    hb = np.asarray(b["noise_floor_hist"], np.float64)
    wa = np.diff(np.asarray(a["noise_floor_edges"]))
    # normalized densities -> TV distance in [0, 1]
    tv = 0.5 * float(np.sum(np.abs(ha - hb) * wa))
    da = np.asarray(a["return_density_vs_range"], np.float64)
    db = np.asarray(b["return_density_vs_range"], np.float64)
    return {
        "noise_floor_tv_distance": tv,
        "return_density_l1": float(np.mean(np.abs(da - db))),
        "return_fraction_delta": abs(a["return_fraction"]
                                     - b["return_fraction"]),
        "dynamic_range_mean_delta": abs(a["dynamic_range_per_column_mean"]
                                        - b["dynamic_range_per_column_mean"]),
    }
