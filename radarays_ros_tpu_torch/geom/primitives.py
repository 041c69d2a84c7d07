"""Procedural triangle-mesh primitives (NumPy, host side).

Copies of radarays_ros_tpu/geom/primitives.py:make_plane/make_box/
make_urban_scene — the reference package cannot be imported without jax.
tests/test_torch_geom.py holds the vertices bit-identical for the same seed.
All functions return (T, 3, 3) float32 vertex arrays with outward-facing
counter-clockwise winding.
"""

from __future__ import annotations

import numpy as np


def _quad(a, b, c, d):
    """Two CCW triangles for quad a-b-c-d."""
    return np.array([[a, b, c], [a, c, d]], np.float32)


def make_plane(center=(0, 0, 0), size=(1.0, 1.0), normal_axis=2, flip=False):
    """Axis-aligned rectangle; normal along +axis (or - if flip)."""
    cx, cy, cz = center
    sx, sy = size[0] / 2.0, size[1] / 2.0
    if normal_axis == 2:
        pts = [(cx - sx, cy - sy, cz), (cx + sx, cy - sy, cz),
               (cx + sx, cy + sy, cz), (cx - sx, cy + sy, cz)]
    elif normal_axis == 1:
        pts = [(cx - sx, cy, cz - sy), (cx - sx, cy, cz + sy),
               (cx + sx, cy, cz + sy), (cx + sx, cy, cz - sy)]
    else:
        pts = [(cx, cy - sx, cz - sy), (cx, cy + sx, cz - sy),
               (cx, cy + sx, cz + sy), (cx, cy - sx, cz + sy)]
    tris = _quad(*pts)
    if flip:
        tris = tris[:, ::-1, :]
    return tris


def make_box(center=(0, 0, 0), size=(1.0, 1.0, 1.0)):
    """Closed axis-aligned box, 12 triangles, outward normals."""
    c = np.asarray(center, np.float32)
    h = np.asarray(size, np.float32) / 2.0
    x0, y0, z0 = c - h
    x1, y1, z1 = c + h
    p = {
        (i, j, k): np.array(
            [x0 if i == 0 else x1, y0 if j == 0 else y1, z0 if k == 0 else z1],
            np.float32,
        )
        for i in (0, 1) for j in (0, 1) for k in (0, 1)
    }
    faces = [
        # -x, +x
        _quad(p[0, 0, 0], p[0, 0, 1], p[0, 1, 1], p[0, 1, 0]),
        _quad(p[1, 0, 0], p[1, 1, 0], p[1, 1, 1], p[1, 0, 1]),
        # -y, +y
        _quad(p[0, 0, 0], p[1, 0, 0], p[1, 0, 1], p[0, 0, 1]),
        _quad(p[0, 1, 0], p[0, 1, 1], p[1, 1, 1], p[1, 1, 0]),
        # -z, +z
        _quad(p[0, 0, 0], p[0, 1, 0], p[1, 1, 0], p[1, 0, 0]),
        _quad(p[0, 0, 1], p[1, 0, 1], p[1, 1, 1], p[0, 1, 1]),
    ]
    return np.concatenate(faces, axis=0)


def make_urban_scene(n_buildings=60, extent=120.0, seed=0, ground=True):
    """Procedural urban-like benchmark scene: ground plane + random boxes.

    Object 0 is the ground, objects 1..n are buildings. Returns
    (parts, names).
    """
    rng = np.random.default_rng(seed)
    parts = []
    names = []
    if ground:
        parts.append(make_plane((0, 0, 0), (2 * extent, 2 * extent), 2))
        names.append("ground")
    for i in range(n_buildings):
        w, d = rng.uniform(2.0, 14.0, 2)
        h = rng.uniform(3.0, 25.0)
        # keep a clearing around the sensor at the origin
        while True:
            x, y = rng.uniform(-extent, extent, 2)
            if x * x + y * y > 15.0**2:
                break
        parts.append(make_box((x, y, h / 2.0), (w, d, h)))
        names.append(f"building_{i}")
    return parts, names
