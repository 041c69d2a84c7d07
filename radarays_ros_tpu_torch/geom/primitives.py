"""Procedural triangle-mesh primitives (NumPy, host side).

Copies of radarays_ros_tpu/geom/primitives.py — the reference package cannot
be imported without jax. tests/test_torch_geom.py and test_torch_native.py
hold the vertices bit-identical for the same seed.
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


def make_cylinder(center=(0, 0, 0), radius=1.0, height=1.0, segments=32,
                  capped=True):
    """Z-axis cylinder with outward normals."""
    cx, cy, cz = center
    z0, z1 = cz - height / 2.0, cz + height / 2.0
    ang = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    xs = cx + radius * np.cos(ang)
    ys = cy + radius * np.sin(ang)
    tris = []
    for i in range(segments):
        j = (i + 1) % segments
        a = (xs[i], ys[i], z0)
        b = (xs[j], ys[j], z0)
        c_ = (xs[j], ys[j], z1)
        d = (xs[i], ys[i], z1)
        tris.append(_quad(a, b, c_, d))
        if capped:
            tris.append(np.array([[(cx, cy, z1), c_, d]], np.float32)[:, ::-1, :])
            tris.append(np.array([[(cx, cy, z0), a, b]], np.float32))
    return np.concatenate(tris, axis=0)


def make_icosphere(center=(0, 0, 0), radius=1.0, subdivisions=2):
    """Icosphere with outward normals."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
         (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
         (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64,
    )
    for _ in range(subdivisions):
        new_faces = []
        verts = list(verts)
        midcache = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in midcache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                m /= np.linalg.norm(m)
                verts.append(m)
                midcache[key] = len(verts) - 1
            return midcache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = np.array(new_faces, np.int64)
        verts = np.array(verts, np.float64)
    verts = verts * radius + np.asarray(center, np.float64)
    return verts[faces].astype(np.float32)


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


def _rot_z(tris: np.ndarray, yaw: float, about) -> np.ndarray:
    """Rotate a (T, 3, 3) triangle soup around the z axis through `about`."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    a = np.asarray([about[0], about[1], 0.0], np.float32)
    return ((tris - a) @ R.T + a).astype(np.float32)


def make_canyon_scene(n_blocks=8, street_w=18.0, block_len=40.0, seed=0,
                      extent=None, clutter=1.0):
    """Dense urban-canyon scene: continuous building facades along a street
    grid with the sensor at a crossing, plus street-level clutter.

    The KAIST02-class regime for the published-figure comparison
    (docs/EVAL_VS_PUBLISHED.md): unlike the sparse box-town of
    make_urban_scene, nearly every azimuth meets facades at several
    ranges/corners AND street-level scatterers — parked cars (yawed
    boxes), trees (trunk + random-facet canopy) and bush/fence clutter
    strips, the content class that fills the reference's scanned KAIST02
    mesh. `clutter` scales the scatterer density (0 = facades+poles
    only). Object 0 is the ground; facades/cars/trees/poles follow.
    Returns (parts, names).
    """
    rng = np.random.default_rng(seed)
    parts = []
    names = []
    half = n_blocks * (block_len + street_w) / 2.0
    ext = extent or (half + street_w)
    parts.append(make_plane((0, 0, 0), (2 * ext, 2 * ext), 2))
    names.append("ground")
    # street grid: facades face the streets; each block edge is a row of
    # adjoining building fronts with jittered heights/setbacks
    coords = (np.arange(n_blocks + 1) - n_blocks / 2.0) * (block_len + street_w)
    bi = 0
    for axis in (0, 1):
        for line in coords:
            pos = -half
            while pos < half:
                seg = rng.uniform(8.0, 22.0)
                seg = min(seg, half - pos)
                if seg < 4.0:
                    break
                h = rng.uniform(6.0, 28.0)
                setback = rng.uniform(0.0, 2.5)
                depth = rng.uniform(6.0, 14.0)
                mid = pos + seg / 2.0
                for sgn in (-1.0, 1.0):
                    c_perp = line + sgn * (street_w / 2.0 + setback
                                           + depth / 2.0)
                    center = ((mid, c_perp, h / 2.0) if axis == 0
                              else (c_perp, mid, h / 2.0))
                    size = ((seg, depth, h) if axis == 0
                            else (depth, seg, h))
                    # keep the sensor crossing open
                    cx, cy = center[0], center[1]
                    if abs(cx) < street_w and abs(cy) < street_w:
                        continue
                    parts.append(make_box(center, size))
                    names.append(f"facade_{bi}")
                    bi += 1
                pos += seg
    # street furniture: poles give the sparse bright point returns radar
    # images show along roads
    for i in range(n_blocks * 8):
        along = rng.uniform(-half, half)
        line = coords[rng.integers(0, len(coords))]
        off = rng.uniform(-street_w * 0.35, street_w * 0.35)
        x, y = (along, line + off) if i % 2 == 0 else (line + off, along)
        if x * x + y * y < 6.0**2:
            continue
        parts.append(make_cylinder((x, y, 2.5), radius=0.15, height=5.0,
                                   segments=6))
        names.append(f"pole_{i}")

    def street_spot():
        along = rng.uniform(-half, half)
        line = coords[rng.integers(0, len(coords))]
        off = rng.uniform(-street_w * 0.45, street_w * 0.45)
        return (along, line + off) if rng.random() < 0.5 \
            else (line + off, along)

    # parked cars: yawed boxes hugging the street edges — each contributes
    # a few bright facets at its own range/azimuth
    for i in range(int(clutter * n_blocks * 14)):
        x, y = street_spot()
        if x * x + y * y < 6.0**2:
            continue
        L, W_, H = rng.uniform(3.6, 5.2), rng.uniform(1.6, 2.0), \
            rng.uniform(1.3, 1.8)
        yaw = rng.uniform(0, np.pi)
        parts.append(_rot_z(make_box((x, y, H / 2.0), (L, W_, H)), yaw,
                            (x, y)))
        names.append(f"car_{i}")
    # trees: trunk + a canopy of random-orientation facets; the canopy is
    # the vegetation-speckle content class of scanned urban meshes —
    # facets at every orientation return at every incidence angle
    for i in range(int(clutter * n_blocks * 10)):
        x, y = street_spot()
        if x * x + y * y < 7.0**2:
            continue
        parts.append(make_cylinder((x, y, 1.5), radius=0.22, height=3.0,
                                   segments=5))
        names.append(f"trunk_{i}")
        r_c = rng.uniform(1.2, 2.6)
        n_f = int(rng.integers(24, 48))
        ctr = np.array([x, y, 3.0 + r_c * 0.7], np.float32)
        pos = ctr + rng.normal(0, r_c * 0.5, (n_f, 3)).astype(np.float32)
        a = rng.normal(0, 0.5, (n_f, 3)).astype(np.float32)
        b = rng.normal(0, 0.5, (n_f, 3)).astype(np.float32)
        canopy = np.stack([pos, pos + a, pos + b], axis=1)
        parts.append(canopy.astype(np.float32))
        names.append(f"canopy_{i}")
    # bush/fence strips: low jittered facet rows along facade feet
    for i in range(int(clutter * n_blocks * 6)):
        x, y = street_spot()
        if x * x + y * y < 6.0**2:
            continue
        n_f = int(rng.integers(10, 20))
        along_dir = rng.random() < 0.5
        ts = np.arange(n_f, dtype=np.float32) * 0.7
        px = x + (ts if along_dir else rng.normal(0, 0.3, n_f))
        py = y + (rng.normal(0, 0.3, n_f) if along_dir else ts)
        pos = np.stack([px, py, rng.uniform(0.2, 0.9, n_f)],
                       axis=1).astype(np.float32)
        a = rng.normal(0, 0.45, (n_f, 3)).astype(np.float32)
        b = rng.normal(0, 0.45, (n_f, 3)).astype(np.float32)
        parts.append(np.stack([pos, pos + a, pos + b], axis=1)
                     .astype(np.float32))
        names.append(f"bush_{i}")
    return parts, names
