"""Process groups of the multi-device layouts (the process-group side of
the reference's parallel/sharding.py:make_mesh, make_mesh_2d,
make_mesh_scene and make_mesh_az_scene).

A mesh lays the ranks of the default process group out row-major over its
axes, as the reference lays its devices out (`np.array(devs).reshape(...)`):
on a mesh ("az", "smp") of 2 x 2, rank r sits at az = r // 2, smp = r % 2.
Each axis has one group per line of ranks along it, made with
`dist.new_group` by every rank in the same order (group creation is
collective); a rank keeps the group of its own line.

The trace reads the scene axis by name (`cfg.trace_scene_axis`, a plain
hashable config value): a scene-sharded layout registers its group under
that name for the span of its frame (`scene_axis`), and `axis_group`
finds it there. Outside a layout no name is registered.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch.distributed as dist


class Mesh(NamedTuple):
    """The ranks of the default group laid out row-major over named axes."""

    shape: Dict[str, int]     # axis name -> size, in the layout's order
    groups: Dict[str, object]  # axis name -> this rank's group along it
    coords: Dict[str, int]    # axis name -> this rank's index along it


def _mesh(names, sizes) -> Mesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(sizes)) != world:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {int(np.prod(sizes))} "
            f"ranks; the process group has {world}")
    grid = np.arange(world).reshape(sizes)
    groups = {}
    for ax, name in enumerate(names):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax]):
            group = dist.new_group(line.tolist())
            if rank in line:
                groups[name] = group
    coords = np.unravel_index(rank, sizes)
    return Mesh(dict(zip(names, sizes)), groups,
                {n: int(c) for n, c in zip(names, coords)})


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "az") -> Mesh:
    """1-D mesh over every rank (n_devices, if given, must be the world
    size: a layout's collectives run over the whole default group)."""
    return _mesh((axis_name,), (n_devices or dist.get_world_size(),))


def make_mesh_2d(n_az: Optional[int] = None, n_smp: int = 2,
                 axis_names=("az", "smp")) -> Mesh:
    """2-D (azimuth x sample) mesh; n_az defaults to world // n_smp."""
    n_az = n_az or dist.get_world_size() // n_smp
    return _mesh(tuple(axis_names), (n_az, n_smp))


def make_mesh_scene(n_devices: Optional[int] = None,
                    axis_name: str = "scene") -> Mesh:
    """1-D mesh for scene (chunk-table) sharding."""
    return make_mesh(n_devices, axis_name)


def make_mesh_az_scene(n_az: Optional[int] = None, n_scene: int = 2,
                       axis_names=("az", "scene")) -> Mesh:
    """2-D mesh composing azimuth data-parallelism with scene sharding."""
    return make_mesh_2d(n_az, n_scene, axis_names)


_AXES: Dict[str, object] = {}


@contextlib.contextmanager
def scene_axis(name: str, group):
    """Register `group` under the axis name `name` while the block runs
    (the trace of every bounce then merges its winners over it)."""
    prev = _AXES.get(name)
    _AXES[name] = group
    try:
        yield
    finally:
        if prev is None:
            del _AXES[name]
        else:
            _AXES[name] = prev


def axis_group(name: str):
    """The group registered under `name`, or None outside a layout."""
    return _AXES.get(name)
