"""The multi-device dry run (counterpart of __graft_entry__.py:
dryrun_multichip) and the worker that runs the layouts in each rank.

    from radarays_ros_tpu_torch.parallel.dryrun import dryrun_multidevice
    dryrun_multidevice(4, device="cuda", backend="gloo")   # 4 ranks
    dryrun_multidevice(2, device="cpu", backend="gloo")

`layouts_rank` is a run_ranks worker (parallel/launch.py): on a setup
given as numpy (host build, parameters, config, poses, random inputs) it
runs the frame layouts named, a training step and scene-sharded traces,
and returns rank 0's results as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from radarays_ros_tpu_torch.geom.scene import bake_tri_aux, scene_tensors
from radarays_ros_tpu_torch.parallel import sharding as SH
from radarays_ros_tpu_torch.parallel.launch import run_ranks
from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams, params_from_numpy)
from radarays_ros_tpu_torch.trace.api import combine_trace_shards, trace

# layout name -> (frame function, mesh maker, whether ranks hold a shard)
LAYOUTS = {
    "az": (SH.simulate_frame_sharded, SH.make_mesh, False),
    "az_smp": (SH.simulate_frame_sharded_2d, SH.make_mesh_2d, False),
    "scene": (SH.simulate_frame_scene_sharded, SH.make_mesh_scene, True),
    "az_scene": (SH.simulate_frame_sharded_az_scene, SH.make_mesh_az_scene,
                 True),
}


def _tiny_setup(n_angles: int = 16, n_samples: int = 4):
    """The port's copy of __graft_entry__.py:_tiny_setup: a 40 m box room
    with a pillar (chunk size 8), three materials, the "mxu" engine.
    Returns (host build, params as numpy, cfg)."""
    from radarays_ros_tpu_torch.geom.primitives import make_box
    from radarays_ros_tpu_torch.geom.scene import Scene

    walls = make_box((0, 0, 0), (40.0, 40.0, 8.0))[:, ::-1, :]
    pillar = make_box((8.0, 0, 0), (2.0, 2.0, 8.0))
    scene = Scene.compose([walls, pillar], ["walls", "pillar"], chunk_size=8)
    materials = Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.15, ambient=1.0, diffuse=0.2, specular=300.0),
        dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0),
    ])
    params = RadarParams.make(materials, [1, 2], beam_width_deg=2.0)
    cfg = RadarModelConfig(
        n_angles=n_angles, n_cells=128, n_samples=n_samples, n_reflections=2,
        resolution=0.25, signal_denoising=1,
        signal_denoising_triangular_width=5,
        signal_denoising_triangular_mode=0.4,
        ambient_noise=2, trace_engine="mxu", trace_ray_block=256,
    )
    return scene.host_arrays(cache=False), params_numpy(params), cfg


def params_numpy(params: RadarParams) -> tuple:
    """RadarParams -> the numpy tuple params_from_numpy takes."""
    m = params.materials
    return tuple(x.detach().cpu().numpy() for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        params.object_materials, params.beam_width))


def baked(st, params: RadarParams, cfg: RadarModelConfig):
    """The scene (or shard) with the object->material map baked into its
    fetch rows where cfg.trace_aux_baked asks for it, as Radar bakes it."""
    if not cfg.trace_aux_baked:
        return st
    om = params.object_materials
    return bake_tri_aux(st, om.float()[st.obj_ids.clamp(
        0, om.shape[0] - 1).long()])


def _numpy(x):
    return None if x is None else x.detach().cpu().numpy()


def layouts_rank(rank: int, world: int, device, setup, frames=(), train=None,
                 traces=None, refused=False) -> dict:
    """run_ranks worker. setup = (host SceneHost, params as numpy, cfg,
    poses, inputs: dict of numpy random inputs for the layouts' keywords).
    frames: (name, layout, cfg overrides) triples, layout a LAYOUTS key;
    train: (target, lr[, params as numpy]) for one train_step_sharded over
    all ranks, from the setup's parameters or those given; traces:
    (host, origins, directions) traced on the "sweep" engine against each
    rank's scene shard and combined; refused: probe that a mesh which does
    not divide the azimuths is refused. Returns rank 0's results."""
    host, params_np, cfg, poses, inputs = setup
    params = params_from_numpy(*params_np, device=device)
    out = {}
    whole = None
    for name, layout, overrides in frames:
        fn, make, sharded = LAYOUTS[layout]
        c = cfg.replace(**overrides)
        mesh = make()
        if sharded:
            st = baked(SH.scene_shard(host, mesh, device), params, c)
        else:
            if whole is None:
                whole = scene_tensors(host, device)
            st = baked(whole, params, c)
        res = fn(st, params, c, poses, mesh, device=device, **inputs)
        out[name] = tuple(_numpy(x) for x in res)
    if train is not None or refused:
        mesh = SH.make_mesh()
        if whole is None:
            whole = scene_tensors(host, device)
        st = baked(whole, params, cfg)
    if train is not None:
        target, lr, *start = train
        p0 = params_from_numpy(*start[0], device=device) if start else params
        loss, new = SH.train_step_sharded(st, p0, cfg, poses, target, mesh,
                                          lr=lr, device=device, **inputs)
        out["train"] = (float(loss), params_numpy(new))
    if refused:
        try:
            SH.simulate_frame_sharded(st, params, cfg.replace(
                n_angles=cfg.n_angles + 1), np.reshape(poses, (-1, 7))[0],
                mesh, device=device, **inputs)
        except ValueError as e:
            out["refused"] = str(e)
    if traces is not None:
        t_host, o, d = traces
        mesh = SH.make_mesh_scene()
        res = trace(SH.scene_shard(t_host, mesh, device),
                    torch.as_tensor(o, device=device),
                    torch.as_tensor(d, device=device), engine="sweep")
        out["traces"] = tuple(_numpy(x) for x in combine_trace_shards(
            res, mesh.groups["scene"]))
    return out


def dryrun_multidevice(world_size: int, device="cuda", *,
                       backend: str) -> dict:
    """Run every layout once and one training step over world_size ranks
    on the tiny setup (the reference's dryrun_multichip): the azimuth
    frame, the step (a finite loss, moved parameters), the 2-D frame when
    the world size is even, the scene-sharded frame, and the azimuth x
    scene frame when the world size is even. Raises if any check fails;
    returns rank 0's results."""
    n_angles = max(16, 2 * world_size)
    n_angles += (-n_angles) % world_size
    host, params, cfg = _tiny_setup(n_angles=n_angles)
    rng = np.random.default_rng(0)
    S = cfg.n_samples
    inputs = dict(
        cone_draws=(rng.uniform(-np.pi, np.pi, S).astype(np.float32),
                    rng.standard_normal(S).astype(np.float32)),
        random_begin=rng.integers(0, 1000, n_angles))
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                    (n_angles, 1))
    even = world_size >= 2 and world_size % 2 == 0
    frames = [("az", "az", {}), ("scene", "scene", {})]
    if even:
        frames += [("az_smp", "az_smp", {}), ("az_scene", "az_scene", {})]
    target = np.zeros((n_angles, cfg.n_cells), np.float32)
    out = run_ranks(layouts_rank, world_size, backend=backend, device=device,
                    args=((host, params, cfg, poses, inputs), frames,
                          (target, 1e-3)))
    for name, _, _ in frames:
        u8, img, max_val = out[name]
        if u8.shape != (cfg.n_cells, n_angles) or not np.isfinite(img).all():
            raise RuntimeError(f"dry run: the {name} frame is "
                               f"{u8.shape} or not finite")
    loss, new = out["train"]
    moved = not all(np.array_equal(a, b) for a, b in zip(new, params))
    if not (np.isfinite(loss) and moved):
        raise RuntimeError(f"dry run: train step loss {loss}, parameters "
                           f"moved: {moved}")
    return out
