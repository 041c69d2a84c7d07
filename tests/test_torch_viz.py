"""The port's debug-ray tracer (radarays_ros_tpu_torch.viz.rays, the
ray_reflection_test node) against the reference's: the port's plain sweep
engine against the reference's culled engine, and against the brute
oracle, on a closed room with a transmissive pillar (so that reflection,
refraction and material segments all appear). Segment positions and
energies are held within 1e-4; order, bounce, kind, medium and material
exactly.
"""

import numpy as np
import pytest
import torch

from radarays_ros_tpu.sim.config import RadarModelConfig as JxConfig

from test_torch_cli import _segments_close, files  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["single", "fan"])
def test_debug_rays_match_reference(files, mode):
    """trace_debug_rays (port engine sweep) against the reference's (engine
    culled): the same segments in the same order, reflection-then-
    refraction, rays that hit nothing dropped, within 1e-4."""
    from radarays_ros_tpu.geom.mesh import load_mesh as j_load_mesh
    from radarays_ros_tpu.io.config import load_scene_config as j_load
    from radarays_ros_tpu.sim.config import RadarParams as JParams
    from radarays_ros_tpu.viz.rays import trace_debug_rays as j_rays
    from radarays_ros_tpu_torch.geom.mesh import load_mesh
    from radarays_ros_tpu_torch.io.config import load_scene_config
    from radarays_ros_tpu_torch.sim.config import (RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.viz.rays import (segments_to_polylines,
                                                 trace_debug_rays)

    sc, jsc = (load_scene_config(files / "refr.yaml"),
               j_load(files / "refr.yaml"))
    params = RadarParams.make(sc.materials, sc.object_materials, 8.0)
    jparams = JParams.make(jsc.materials, jsc.object_materials, 8.0)
    cfg = RadarModelConfig(trace_engine="sweep", trace_ray_block=128)
    jcfg = JxConfig(trace_engine="culled", trace_ray_block=128)
    pose = make_pose([0.5, -0.5, 1.0], [0, 0, 0.0998, 0.995])
    kw = dict(yaw=0.3, n_bounces=3, mode=mode, n_fan=72)
    got = trace_debug_rays(load_mesh(files / "scene.obj", 8).to_device("cpu"),
                           params, cfg, pose, **kw)
    want = j_rays(j_load_mesh(files / "scene.obj", 8).device_arrays(),
                  jparams, jcfg, pose, **kw)
    _segments_close(got, want)
    kinds = {s["kind"] for s in got["segments"]}
    assert {"primary", "reflection", "refraction"} <= kinds
    assert {"air", "material"} <= {s["medium"] for s in got["segments"]}
    lines = segments_to_polylines(got)
    assert sum(map(len, lines.values())) == len(got["segments"])
    brute = trace_debug_rays(load_mesh(files / "scene.obj", 8)
                             .to_device("cpu"), params,
                             cfg.replace(trace_engine="brute"), pose, **kw)
    _segments_close(brute, got)
