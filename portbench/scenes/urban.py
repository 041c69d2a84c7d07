"""The urban scene: a procedural city made from the scene's own seed.

A flat ground square (object 0, two triangles) and `n_buildings` closed
axis-aligned boxes (objects 1..n, twelve triangles each, outward normals),
the kind of scene the port's `geom/primitives.py:make_urban_scene` makes
(there one box at a time; here all boxes at once, vectorized). Box widths
and depths are uniform in [2, 14] m, heights in [3, 25] m, centres uniform
over the square of half-width `extent`. Boxes are kept out of the clearings
the sensor drives through: a disc of `clear_radius` around the origin and,
where `ring_radius` is set, a ring road of half-width `ring_half_width`
around the circle the trajectories follow. A rejected box is drawn again,
so the count is exact.

A configuration names it as `"scene": {"kind": "urban", ...}`; the other
keys of that group, but `chunk_size`, are this function's arguments.

The scene is the benchmark's input: the port gets the soup through its
public host build, and the reference traces the same soup (float32
vertices), never the port's ordered scene.
"""

from __future__ import annotations

import numpy as np

# corner index (i, j, k) -> bit i + 2j + 4k; two CCW triangles a face, in
# the face order of a box built face by face (-x, +x, -y, +y, -z, +z)
_QUADS = (((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)),
          ((1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)),
          ((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)),
          ((0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)),
          ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)),
          ((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)))


def _box_corners():
    """(12, 3, 3) corner selectors: 1 picks the box's upper bound."""
    tris = []
    for a, b, c, d in _QUADS:
        tris += [(a, b, c), (a, c, d)]
    return np.asarray(tris, np.float32)


_BOX = _box_corners()


def _centres(rng, n: int, extent: float, clear_radius: float,
             ring_radius, ring_half_width: float) -> np.ndarray:
    out = np.empty((0, 2))
    while out.shape[0] < n:
        xy = rng.uniform(-extent, extent, (2 * (n - out.shape[0]) + 16, 2))
        r = np.hypot(xy[:, 0], xy[:, 1])
        keep = r > clear_radius
        if ring_radius is not None:
            keep &= np.abs(r - ring_radius) > ring_half_width
        out = np.concatenate([out, xy[keep]])
    return out[:n]


def soup(seed: int, n_buildings: int, extent: float,
               clear_radius: float = 15.0, ring_radius=None,
               ring_half_width: float = 0.0):
    """(verts (T, 3, 3) float32, obj_ids (T,) int32, n_objects)."""
    rng = np.random.default_rng(seed)
    wd = rng.uniform(2.0, 14.0, (n_buildings, 2))
    h = rng.uniform(3.0, 25.0, n_buildings)
    xy = _centres(rng, n_buildings, extent, clear_radius, ring_radius,
                  ring_half_width)
    lo = np.stack([xy[:, 0] - wd[:, 0] / 2, xy[:, 1] - wd[:, 1] / 2,
                   np.zeros(n_buildings)], -1)
    size = np.stack([wd[:, 0], wd[:, 1], h], -1)
    boxes = (lo[:, None, None, :] + _BOX[None] * size[:, None, None, :])
    e = 2.0 * extent
    g = np.array([[-e / 2, -e / 2, 0], [e / 2, -e / 2, 0], [e / 2, e / 2, 0],
                  [-e / 2, e / 2, 0]])
    ground = np.stack([g[[0, 1, 2]], g[[0, 2, 3]]])
    verts = np.concatenate([ground, boxes.reshape(-1, 3, 3)]).astype(
        np.float32)
    obj = np.concatenate([np.zeros(2, np.int32),
                          np.repeat(np.arange(1, n_buildings + 1,
                                              dtype=np.int32), 12)])
    return verts, obj, n_buildings + 1
