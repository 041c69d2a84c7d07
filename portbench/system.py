"""The system under test, built from a configuration file through the
port's public entries: the scene soup made from the configuration's seed
(portbench/scenes/), the port's host build with the scene cache off, the
upload, the material table and the frame configuration.

The reference side (portbench/reference/) is handed the same soup, the
same material numbers and the same radar settings from the configuration
file, never anything the port made from them.
"""

from __future__ import annotations

import importlib
import time
from typing import NamedTuple

import numpy as np
import torch


MAT_KEYS = ("velocity", "ambient", "diffuse", "specular")


class Soup(NamedTuple):
    verts: np.ndarray        # (T, 3, 3) float32
    obj: np.ndarray          # (T,) int32
    n_objects: int


class System(NamedTuple):
    scene: object            # the port's SceneTensors, material map baked
    cfg: object              # the port's RadarModelConfig
    soup: Soup
    object_materials: np.ndarray   # (n_objects,) int32
    build_s: dict            # seconds by stage


def make_soup(conf: dict) -> Soup:
    """The configuration's scene, made from its own seed by the module of
    its kind (portbench/scenes/<kind>.py): every run of a cell traces the
    same scene, whatever the run's seed."""
    s = dict(conf["scene"])
    kind = importlib.import_module(f"portbench.scenes.{s.pop('kind')}")
    s.pop("chunk_size", None)
    return Soup(*kind.soup(**s))


def object_materials(conf: dict, n_objects: int) -> np.ndarray:
    om = np.full(n_objects, conf["object_materials"]["buildings"], np.int32)
    om[0] = conf["object_materials"]["ground"]
    return om


def material_table(entries, device) -> torch.Tensor:
    """(M, 4) float32 [velocity, ambient, diffuse, specular] from dict
    entries."""
    return torch.tensor([[float(e[k]) for k in MAT_KEYS] for e in entries],
                        dtype=torch.float32, device=device)


def port_params(table: torch.Tensor, om: np.ndarray, beam_width_deg: float):
    """The port's RadarParams of an (M, 4) float32 table."""
    from radarays_ros_tpu_torch.sim.config import Materials, RadarParams

    return RadarParams.make(Materials(*table.unbind(1)), om,
                            beam_width_deg=beam_width_deg)


def build(conf: dict, device) -> System:
    """The port's scene and frame configuration for `conf`."""
    from radarays_ros_tpu_torch.geom.scene import (Scene, bake_tri_aux,
                                                   scene_tensors)
    from radarays_ros_tpu_torch.sim.config import RadarModelConfig

    t = [time.perf_counter()]
    soup = make_soup(conf)
    t.append(time.perf_counter())
    scene = Scene(soup.verts, soup.obj, None, conf["scene"]["chunk_size"])
    host = scene.host_arrays(cache=False)
    t.append(time.perf_counter())
    st = scene_tensors(host, device)
    om = object_materials(conf, soup.n_objects)
    row = torch.from_numpy(om).to(device).float()
    st = bake_tri_aux(st, row[st.obj_ids.clamp(0, soup.n_objects - 1).long()])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    cfg = RadarModelConfig(**conf["radar"])
    return System(st, cfg, soup, om,
                  dict(soup_s=t[1] - t[0], host_build_s=t[2] - t[1],
                       upload_s=t[3] - t[2]))
