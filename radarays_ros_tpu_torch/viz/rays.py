"""Ray-reflection debugging: the `ray_reflection_test` node, data-first
(counterpart of radarays_ros_tpu/viz/rays.py).

The reference's debug node (src/ray_reflection_test.cpp:169-354) traces a
beam through the mesh for B bounces and publishes each segment as an rviz
LINE_LIST marker colored by medium (red = air, green = inside a material).
Here the same trace gives a JSON-able dict that the CLI dumps and the tests
assert on. The trace runs through `trace()`: on CUDA tensors the kernel
engine launches the culling prep and the sweep (K4 or K2+K3, then K1) on a
partly filled ray block whose padding lanes have budget 0.

Beam modes (RayReflection.cfg):
  * "single" — one ray at `yaw` (ray_reflection_test.cpp:196-205);
  * "fan"    — n_fan rays spread over 360 deg (shoot_all_directions,
               ray_reflection_test.cpp:207-222);
  * "cone"   — the radar beam cone sampled with the configured distribution
               (ray_reflection_test.cpp:224-240), drawn from a
               torch.Generator seeded with `seed`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from radarays_ros_tpu_torch.sim.config import RadarModelConfig, RadarParams
from radarays_ros_tpu_torch.trace.api import resolve_engine, trace
from radarays_ros_tpu_torch.utils.transforms import pose_matrix, rotz
from radarays_ros_tpu_torch.wave.cone import sample_cone_local
from radarays_ros_tpu_torch.wave.fresnel import fresnel_split
from radarays_ros_tpu_torch.wave.types import (Waves, broadcast_waves,
                                               make_start_wave_attrs)


def _initial_dirs(cfg: RadarModelConfig, params: RadarParams, yaw: float,
                  mode: str, n_fan: int, seed: int, device) -> torch.Tensor:
    if mode == "single":
        d = np.asarray([[np.cos(yaw), np.sin(yaw), 0.0]], np.float32)
        return torch.from_numpy(d).to(device)
    if mode == "fan":
        a = yaw + np.arange(n_fan) * (2 * np.pi / n_fan)
        d = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)],
                     -1).astype(np.float32)
        return torch.from_numpy(d).to(device)
    if mode == "cone":
        gen = torch.Generator(device).manual_seed(seed)
        local = sample_cone_local(gen, params.beam_width, cfg.n_samples,
                                  cfg.beam_sample_dist,
                                  cfg.beam_sample_dist_normal_p_in_cone)
        R = rotz(torch.tensor(yaw, dtype=torch.float32, device=device))
        return torch.einsum("ij,sj->si", R, local)
    raise ValueError(f"unknown beam mode {mode!r}")


def trace_debug_rays(scene, params: RadarParams, cfg: RadarModelConfig,
                     pose, *, yaw: float = 0.0, n_bounces: int = 3,
                     mode: str = "single", n_fan: int = 360,
                     seed: int = 0) -> Dict:
    """Trace a debug beam for n_bounces over SceneTensors; return the
    segment list.

    Returns {"segments": [{bounce, start, end, energy, material_id, medium,
    kind}, ...], "n_rays": N}; `kind` is "primary", "reflection" or
    "refraction", `medium` "air" or "material" (the red/green coloring of
    ray_reflection_test.cpp:277-307). Rays that hit nothing are dropped, as
    the reference's marker output drops them. Each bounce's rays are the
    reflections of the previous bounce's followed by their refractions.
    """
    dev = scene.device
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    R_sm, t_sm = pose_matrix(pose)
    dirs0 = torch.einsum("ij,sj->si", R_sm, _initial_dirs(
        cfg, params, yaw, mode, n_fan, seed, dev))
    N = dirs0.shape[0]

    waves = broadcast_waves(
        torch.broadcast_to(t_sm, (1, N, 3)), dirs0[None],
        make_start_wave_attrs(material_id=cfg.material_id_air), (1, N))
    kinds = ["primary"] * N
    engine = resolve_engine(cfg.trace_engine, dev)
    kw = {} if engine == "brute" else dict(ray_block=cfg.trace_ray_block)

    segments = []
    for bounce in range(n_bounces):
        res = trace(scene, waves.orig, waves.dir, engine=engine, **kw)
        alive = waves.valid & res.hit
        incidence = waves.move(torch.where(alive, res.t, 0.0))

        orig = waves.orig[0].cpu().numpy()
        endp = incidence.orig[0].cpu().numpy()
        energy = waves.energy[0].cpu().numpy()
        mat = waves.material_id[0].cpu().numpy()
        ok = alive[0].cpu().numpy()
        for i in range(orig.shape[0]):
            if not ok[i]:
                continue
            segments.append(dict(
                bounce=bounce,
                start=[round(float(v), 6) for v in orig[i]],
                end=[round(float(v), 6) for v in endp[i]],
                energy=round(float(energy[i]), 6),
                material_id=int(mat[i]),
                medium=("air" if int(mat[i]) == cfg.material_id_air
                        else "material"),
                kind=kinds[i],
            ))

        if bounce == n_bounces - 1:
            break

        # split (Fresnel over the velocity table,
        # ray_reflection_test.cpp:320-337)
        in_air = waves.material_id == cfg.material_id_air
        om = params.object_materials
        obj = torch.clamp(res.obj_id, 0, om.shape[0] - 1).long()
        refr_mat = torch.where(in_air, om[obj], cfg.material_id_air)
        same = refr_mat == waves.material_id
        v2 = torch.where(same, waves.velocity,
                         params.materials.velocity[refr_mat.long()])
        fres = fresnel_split(res.normal, waves.dir, incidence.energy,
                             incidence.polarization, incidence.velocity, v2)
        thresh = cfg.wave_energy_threshold
        refl = incidence._replace(
            dir=fres.reflection_dir, energy=fres.reflection_energy,
            valid=alive & (fres.reflection_energy > thresh),
        ).move(cfg.skip_dist)
        refr_ok = torch.sum(fres.refraction_dir ** 2, dim=-1) > 0.25
        refr = incidence._replace(
            dir=fres.refraction_dir, energy=fres.refraction_energy,
            velocity=torch.where(refr_ok, v2, incidence.velocity),
            material_id=torch.where(refr_ok, refr_mat,
                                    incidence.material_id).to(torch.int32),
            valid=alive & (fres.refraction_energy > thresh) & refr_ok,
        ).move(cfg.skip_dist)
        waves = Waves(*(torch.cat([a, b], dim=1) for a, b in zip(refl, refr)))
        kinds = ["reflection"] * len(kinds) + ["refraction"] * len(kinds)

    return {"segments": segments, "n_rays": int(N)}


def segments_to_polylines(result: Dict):
    """Group segments into per-medium polyline lists for plotting."""
    out = {"air": [], "material": []}
    for seg in result["segments"]:
        out[seg["medium"]].append((seg["start"], seg["end"], seg["energy"]))
    return out
