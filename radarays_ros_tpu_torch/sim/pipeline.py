"""The radar frame: pose(s) -> uint8 polar image (counterpart of
radarays_ros_tpu/sim/pipeline.py).

One frame: cone sampling, the pose and azimuth rotations, `n_reflections`
bounces (trace under the per-ray image-range budget, material from the
per-triangle aux column or the object map, Fresnel split into a reflection
and a refraction child, back-reflection shading, the path-return and the
multipath air-return signals), binning with the fused denoise, the energy
scale, ambient noise, per-column u8 normalization and the scroll.

With `opaque_materials` (every non-air material has velocity 0, so the
refraction branch is provably dead) the wave tensor keeps its sample count
every pass; otherwise each pass doubles it, [reflection, refraction] along
the sample axis (the reference's refraction tree, sim/pipeline.py:199-209,
277-289).

Random inputs: torch's generators do not reproduce JAX's streams, so the
frame entry points take the cone draws `cone_draws` (or the directions
`local_dirs`), the Perlin row offsets `random_begin` and the uniform noise
field `uniform` as optional explicit inputs (the scope rule of
tests/numpy_oracle.py); absent ones are drawn from `generator`.

Differentiable w.r.t. the material table and the beam width (through the
cone directions built from the draws, the Moller-Trumbore refinement of
each hit, the material lookup of sim/lookup.py, shading and binning), as
the reference's frame is.

The compiled entries `simulate_frame_jit` and `simulate_frames_jit` (the
reference's jitted frame: one program a config) replay a CUDA graph of
the same frame on the card (sim/graphs.py) and run the eager frame on the
CPU; the frame makes no host copy and no host sync on the card, so that
a graph can hold it. On the card a compiled entry returns the u8 image
on the host, in a fresh page-locked tensor that one asynchronous copy
filled before the call returned (_fetch_u8): every caller of a compiled
entry reads its images on the host, and a card tensor's `.cpu()` is
always a pageable copy. The eager entries keep the whole frame on the
frame's device.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from radarays_ros_tpu_torch.geom.scene import SceneTensors
from radarays_ros_tpu_torch.image.draw import (apply_ambient_noise,
                                               draw_signals, normalize_to_u8)
from radarays_ros_tpu_torch.sim.config import RadarModelConfig, RadarParams
from radarays_ros_tpu_torch.sim.graphs import Compiled
from radarays_ros_tpu_torch.sim.lookup import material_lookup
from radarays_ros_tpu_torch.parallel.groups import axis_group
from radarays_ros_tpu_torch.trace.api import (combine_trace_shards,
                                              resolve_engine, trace)
from radarays_ros_tpu_torch.utils.profiling import annotate
from radarays_ros_tpu_torch.utils.transforms import (azimuth_angles,
                                                     pose_matrix, rotz)
from radarays_ros_tpu_torch.wave.cone import cone_local, sample_cone_draws
from radarays_ros_tpu_torch.wave.fresnel import (_clamped_acos,
                                                 back_reflection_shader,
                                                 cook_torrance_shader,
                                                 fresnel_split,
                                                 get_incidence_angle)
from radarays_ros_tpu_torch.wave.types import (Waves, broadcast_waves,
                                               make_start_wave_attrs)


class FrameResult(NamedTuple):
    image_u8: torch.Tensor     # ([N,] n_cells, n_angles) uint8 polar image
    image_float: torch.Tensor  # ([N,] n_angles, n_cells) float32
    max_val: torch.Tensor      # ([N,] n_angles) per-column raw signal max


def _shade(cfg: RadarModelConfig, mat, angle, energy):
    """Back-reflection shading; the hit material's (ambient, diffuse,
    specular) columns `mat` -> shader (diffuse, specular_fac, specular_exp)
    (RadarCPU.cpp:310-316)."""
    ambient, diffuse, specular = mat
    if cfg.reflection_model == "cook_torrance":
        return cook_torrance_shader(
            angle, energy,
            roughness=torch.clamp_min(diffuse, 1e-3),
            fresnel_f0=torch.clamp(specular / 3000.0, 0.0, 1.0),
            k_diffuse=torch.clamp(ambient, 0.0, 1.0))
    return back_reflection_shader(angle, energy, diffuse=ambient,
                                  specular_fac=diffuse,
                                  specular_exp=specular)


def _trace_ray_major(cfg, scene, waves: Waves, budget):
    """Trace an (N, A, S) wave batch with the frame axis innermost in ray
    order (ray-major, as the reference's batching rule at
    pallas_trace.py:774-788): rays of one block then span few azimuths
    across nearby frames, which keeps block frustums narrow."""
    def rm(x):      # (N, A, S, ...) -> (A, S, N, ...)
        return x.movedim(0, 2)

    engine = resolve_engine(cfg.trace_engine, waves.orig.device)
    kw = {}
    if engine in ("sweep", "kernel"):
        # the reference passes the requeue cap to pallas3 and the sweep cap
        # only to culled (its sim/pipeline.py:136-146)
        kw = dict(ray_block=cfg.trace_ray_block,
                  prep_group=cfg.trace_prep_group,
                  two_phase_cap=cfg.trace_two_phase_cap,
                  with_aux=cfg.trace_aux_baked)
        if engine == "sweep":
            kw["k_chunks"] = cfg.trace_k_chunks
    elif engine == "mxu":
        kw = dict(ray_block=cfg.trace_ray_block, tri_chunk=cfg.trace_tri_chunk)
    res = trace(scene, rm(waves.orig), rm(waves.dir), engine=engine,
                t_budget=rm(budget), t_min=0.0, t_max=1000.0, **kw)
    return type(res)(*(None if x is None else x.movedim(2, 0) for x in res))


def trace_budget(cfg: RadarModelConfig, waves: Waves) -> torch.Tensor:
    """Per-ray trace budget [m]: the image covers n_cells*resolution meters
    of one-way distance and travel time only grows, so a hit arriving past
    the image (plus the denoise splat reach) contributes nothing, nor do its
    descendants — clamping the trace there is exact (the reference's
    sim/pipeline.py:92-109).

    Invalid waves (missed, or below the energy threshold) get budget 0: no
    signal of theirs survives binning (every signal and child is gated by
    `waves.valid & hit`), so only their own, discarded trace results
    change. Their lanes then keep no chunk and never hold the sweep's
    early termination back, like the sweep's padding lanes."""
    weights, _ = cfg.denoiser()
    slack = 0 if weights is None else len(weights)
    t_lim = (cfg.n_cells + slack) * cfg.resolution / 0.3
    if cfg.record_multi_path:
        # the air return travels hit -> sensor directly, which can be
        # arbitrarily short: only time * 1 (not * 2) bounds its signal
        t_lim = 2.0 * t_lim
    budget = torch.clamp_min(t_lim - waves.time, 0.0) * waves.velocity
    return torch.where(waves.valid, budget, 0.0)


def _bounce(cfg: RadarModelConfig, params: RadarParams, scene: SceneTensors,
            waves: Waves, sensor_pos, pass_id: int):
    """One pass over an (N, A, S) wave batch (sensor_pos (N, A, 3)):
    returns the next waves ((N, A, S) opaque, else (N, A, 2S) as
    [reflection, refraction]) and the pass's signals, a list of (time,
    strength, valid): the path return, then the multipath air return."""
    res = _trace_ray_major(cfg, scene, waves, trace_budget(cfg, waves))
    if cfg.trace_scene_axis is not None:
        # a scene-sharded layout merges the ranks' winners here, as the
        # reference does (its sim/pipeline.py:148-153); outside one the
        # axis names no group and the value is ignored
        group = axis_group(cfg.trace_scene_axis)
        if group is not None:
            res = combine_trace_shards(res, group)

    alive = waves.valid & res.hit
    incidence = waves.move(torch.where(alive, res.t, 0.0))

    # material flip: air -> hit object's material, material -> air
    in_air = waves.material_id == cfg.material_id_air
    if res.aux is not None:
        # the baked material of the hit; engines without the fetch (brute,
        # mxu) return no aux, and the map is gathered by object instead
        hit_mat = res.aux.to(torch.int32)
    else:
        om = params.object_materials
        hit_mat = om[torch.clamp(res.obj_id, 0, om.shape[0] - 1).long()]
    refr_mat = torch.where(in_air, hit_mat, cfg.material_id_air).long()
    # the pass's one lookup of the material table (its backward is the
    # kernel rr_table_grad); the shading of both returns reads it too
    velocity, *mat = material_lookup(params.materials, refr_mat).unbind(-1)
    same = refr_mat == waves.material_id
    v2 = torch.where(same, waves.velocity, velocity)
    fres = fresnel_split(res.normal, waves.dir, incidence.energy,
                         incidence.polarization, incidence.velocity, v2)

    thresh = cfg.wave_energy_threshold
    refl_valid = alive & (fres.reflection_energy > thresh)
    reflection = incidence._replace(
        dir=fres.reflection_dir, energy=fres.reflection_energy,
        valid=refl_valid).move(cfg.skip_dist)
    if cfg.opaque_materials:
        next_waves = reflection
    else:
        # the refraction child enters the hit's medium (sim/pipeline.py
        # :199-209 of the reference)
        refr_dir_ok = torch.sum(fres.refraction_dir * fres.refraction_dir,
                                dim=-1) > 0.25
        refr_valid = alive & (fres.refraction_energy > thresh) & refr_dir_ok
        refraction = incidence._replace(
            dir=fres.refraction_dir, energy=fres.refraction_energy,
            velocity=torch.where(refr_valid, v2, incidence.velocity),
            material_id=torch.where(refr_valid, refr_mat,
                                    incidence.material_id).to(torch.int32),
            valid=refr_valid).move(cfg.skip_dist)
        next_waves = Waves(*(torch.cat([a, b], dim=2)
                             for a, b in zip(reflection, refraction)))

    inc_angle = get_incidence_angle(res.normal, waves.dir)
    ret_energy = _shade(cfg, mat, inc_angle, fres.reflection_energy)
    sig_gate = refl_valid & in_air
    path_valid = sig_gate
    if not (pass_id == 0 or cfg.record_multi_reflection):
        path_valid = torch.zeros_like(path_valid)
    signals = [(incidence.time * 2.0, ret_energy, path_valid)]
    # the multipath air return: the hit reflects straight through air back
    # to the sensor (sim/pipeline.py:227-241). The opaque branch emits it
    # on every pass (all invalid on pass 0), as the reference's lax.scan
    # body does, so that its signal layout is the reference's.
    if cfg.record_multi_path and (cfg.opaque_materials or pass_id > 0):
        to_sensor = incidence.orig - sensor_pos[:, :, None, :]
        dist = torch.linalg.norm(to_sensor, dim=-1)
        dir_s2h = to_sensor / torch.clamp_min(dist, 1e-12)[..., None]
        time_to_sensor = dist / reflection.velocity
        view_scalar = torch.sum(waves.dir * dir_s2h, dim=-1)
        angle_air = _clamped_acos(
            torch.sum(-fres.reflection_dir * dir_s2h, dim=-1))
        air_energy = _shade(cfg, mat, angle_air, fres.reflection_energy)
        air_valid = sig_gate & (view_scalar > cfg.multipath_threshold)
        if pass_id == 0:
            air_valid = torch.zeros_like(air_valid)
        signals.append((incidence.time + time_to_sensor, air_energy,
                        air_valid))
    return next_waves, signals


def collect_signals(scene: SceneTensors, params: RadarParams,
                    cfg: RadarModelConfig, waves: Waves, sensor_pos):
    """All bounce passes of an (N, A, S) batch; returns (times, strengths,
    valid) shaped (N, A, n_signals) in the reference's signal order, which
    fixes K5's f32 sum order: opaque — kind-major (every path return, then
    every air return), pass-major within a kind, as the reference's
    lax.scan flatten (sim/pipeline.py:270-276); otherwise pass by pass,
    path then air within a pass (:277-289)."""
    sigs = []
    for pass_id in range(cfg.n_reflections):
        waves, sig = _bounce(cfg, params, scene, waves, sensor_pos, pass_id)
        sigs.append(sig)
    N, A = waves.batch_shape[:2]
    if cfg.opaque_materials:
        flat = [p[k] for k in range(len(sigs[0])) for p in sigs]
    else:
        flat = [sig for p in sigs for sig in p]
    return tuple(torch.cat([f[i].reshape(N, A, -1) for f in flat], dim=2)
                 for i in range(3))


def start_waves(params: RadarParams, cfg: RadarModelConfig, poses, *,
                local_dirs: Optional[torch.Tensor] = None,
                cone_draws=None,
                generator: Optional[torch.Generator] = None,
                device="cpu"):
    """The transmitted (N, A, S) wave batch and the sensor positions
    (N, A, 3): poses (N, 7) or (N, A, 7). The beam-frame directions are
    `local_dirs` (S, 3) or (N, S, 3); else they are built from the cone
    draws `cone_draws` = (theta, radial), each (S,) or (N, S), with the
    current beam width (differentiably); else drawn from `generator`."""
    A, S = cfg.n_angles, cfg.n_samples
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    N = poses.shape[0]
    if poses.dim() == 2:
        poses = poses[:, None, :].expand(N, A, 7)
    if local_dirs is None:
        if cone_draws is None:
            draws = [sample_cone_draws(generator, S, cfg.beam_sample_dist)
                     for _ in range(N)]
            cone_draws = tuple(torch.stack(d) for d in zip(*draws))
        theta, radial = (torch.as_tensor(x, dtype=torch.float32,
                                         device=device) for x in cone_draws)
        local_dirs = cone_local(theta, radial, params.beam_width,
                                cfg.beam_sample_dist,
                                cfg.beam_sample_dist_normal_p_in_cone)
    local_dirs = torch.as_tensor(local_dirs, dtype=torch.float32,
                                 device=device).expand(N, S, 3)
    # beam frame -> map frame: R_am = R_sm @ Rz(theta_a), in true f32
    # (TF32 is off package-wide; RadarCPU.cpp:198-209)
    R_sm, t_sm = pose_matrix(poses)                       # (N, A, 3, 3)
    R_am = torch.matmul(R_sm, rotz(azimuth_angles(A, device)))
    dirs0 = torch.einsum("naij,nsj->nasi", R_am, local_dirs)
    # (0, 0, z_offset) made on the device: no host copy a frame
    offset = torch.zeros(3, device=device)
    offset[2:].fill_(cfg.z_offset)
    sensor_pos = t_sm + offset
    waves = broadcast_waves(
        sensor_pos[:, :, None, :], dirs0,
        make_start_wave_attrs(material_id=cfg.material_id_air), (N, A, S))
    return waves, sensor_pos


def _draw_absent(cfg: RadarModelConfig, N: int, device, local_dirs,
                 cone_draws, random_begin, uniform, generator):
    """The random inputs a frame batch of N needs and was not given, drawn
    from `generator` in simulate_frames' order: the cone draws frame by
    frame (without local_dirs), then the Perlin offsets (ambient noise 2)
    or the uniform field (1). Returns (local_dirs, cone_draws,
    random_begin, uniform); an input the frame does not read is None."""
    A, n_cells = cfg.n_angles, cfg.n_cells
    if local_dirs is not None:
        cone_draws = None
    elif cone_draws is None:
        draws = [sample_cone_draws(generator, cfg.n_samples,
                                   cfg.beam_sample_dist) for _ in range(N)]
        cone_draws = tuple(torch.stack(d) for d in zip(*draws))
    if cfg.ambient_noise != 2:
        random_begin = None
    elif random_begin is None:
        random_begin = torch.randint(0, 1000, (N, A), generator=generator,
                                     device=device)
    if cfg.ambient_noise != 1:
        uniform = None
    elif uniform is None:
        uniform = torch.rand((N, A, n_cells), generator=generator,
                             device=device)
    return local_dirs, cone_draws, random_begin, uniform


def _frames(scene: SceneTensors, params: RadarParams, cfg: RadarModelConfig,
            poses, local_dirs, cone_draws, random_begin, uniform
            ) -> FrameResult:
    """The frame batch on explicit random inputs (those _draw_absent
    returns): simulate_frames' body, and what the compiled entries
    capture."""
    dev = scene.device
    A, n_cells = cfg.n_angles, cfg.n_cells
    waves, sensor_pos = start_waves(params, cfg, poses, local_dirs=local_dirs,
                                    cone_draws=cone_draws, device=dev)
    N = waves.batch_shape[0]
    times, strengths, valid = collect_signals(scene, params, cfg, waves,
                                              sensor_pos)
    weights, mode = cfg.denoiser()
    img, max_val = draw_signals(
        times.reshape(N * A, -1), strengths.reshape(N * A, -1),
        valid.reshape(N * A, -1), n_cells=n_cells,
        resolution=cfg.resolution, denoise_weights=weights,
        denoise_mode=mode, method=cfg.draw_method)
    img = img * cfg.energy_max                           # RadarCPU.cpp:453

    cols = (cfg.scroll_image + torch.arange(A, device=dev)) % A
    img = apply_ambient_noise(
        img, max_val, cols.repeat(N), mode=cfg.ambient_noise,
        resolution=cfg.resolution,
        at_signal_0=cfg.ambient_noise_at_signal_0,
        at_signal_1=cfg.ambient_noise_at_signal_1,
        energy_max=cfg.ambient_noise_energy_max,
        energy_min=cfg.ambient_noise_energy_min,
        energy_loss=cfg.ambient_noise_energy_loss,
        perlin_scale_low=cfg.ambient_noise_perlin_scale_low,
        perlin_scale_high=cfg.ambient_noise_perlin_scale_high,
        perlin_p_low=cfg.ambient_noise_perlin_p_low,
        random_begin=None if random_begin is None else
        torch.as_tensor(random_begin, device=dev).reshape(N * A),
        uniform=None if uniform is None else
        torch.as_tensor(uniform, dtype=torch.float32,
                        device=dev).reshape(N * A, n_cells))

    u8 = normalize_to_u8(img, max_val, cfg.signal_max).view(N, A, n_cells)
    # place azimuth a at column (scroll_image + a) % A (RadarCPU.cpp:457,542)
    placed = torch.zeros_like(u8)
    placed[:, cols] = u8
    return FrameResult(image_u8=placed.transpose(1, 2).contiguous(),
                       image_float=img.view(N, A, n_cells),
                       max_val=max_val.view(N, A))


def simulate_frames(scene: SceneTensors, params: RadarParams,
                    cfg: RadarModelConfig, poses, *,
                    local_dirs: Optional[torch.Tensor] = None,
                    cone_draws=None,
                    random_begin: Optional[torch.Tensor] = None,
                    uniform: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> FrameResult:
    """A batch of N frames on the scene's device.

    poses: (N, 7) one pose per frame or (N, n_angles, 7) per-azimuth poses.
    local_dirs: (S, 3) or (N, S, 3) beam-frame cone directions, or
    cone_draws: (theta, radial) each (S,) or (N, S) (see start_waves);
    random_begin: (N, A) Perlin row offsets; uniform: (N, A, n_cells)
    field — each drawn from `generator` when absent (and needed).
    Returns FrameResult with a leading N axis on every field.
    """
    N = torch.as_tensor(poses).shape[0]
    return _frames(scene, params, cfg, poses, *_draw_absent(
        cfg, N, scene.device, local_dirs, cone_draws, random_begin, uniform,
        generator))


def simulate_frame(scene: SceneTensors, params: RadarParams,
                   cfg: RadarModelConfig, pose, *,
                   local_dirs: Optional[torch.Tensor] = None,
                   cone_draws=None,
                   random_begin: Optional[torch.Tensor] = None,
                   uniform: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> FrameResult:
    """One frame at a (7,) pose or (n_angles, 7) per-azimuth poses; the
    explicit random inputs are unbatched ((S, 3), ((S,), (S,)), (A,),
    (A, n_cells))."""
    return _one_frame(simulate_frames, scene, params, cfg, pose,
                      local_dirs=local_dirs, cone_draws=cone_draws,
                      random_begin=random_begin, uniform=uniform,
                      generator=generator)


def _one_frame(frames, scene, params, cfg, pose, *, random_begin, uniform,
               **kw) -> FrameResult:
    """A frame as the batch of one of `frames`."""
    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    res = frames(scene, params, cfg, one(pose), random_begin=one(random_begin),
                 uniform=one(uniform), **kw)
    return FrameResult(*(x[0] for x in res))


# ------------------------------------------------- the compiled entries

class JitRefused(ValueError):
    """A configuration the compiled entries do not capture on the card
    (jit_refusal): raised before anything runs."""


def jit_refusal(cfg: RadarModelConfig) -> Optional[str]:
    """Why simulate_frame(s)_jit refuses `cfg` on the card, or None. The
    plain "sweep" engine ends its chunk loop on a host test each visit
    rank (trace/cuda_trace.py:_sweep_plain), and a scene-sharded layout
    merges its ranks' traces by gloo collectives: a CUDA graph holds
    neither. Callers that take such configs run the eager entries."""
    if cfg.trace_engine == "sweep":
        return ("trace_engine 'sweep' (the plain ranked sweep) tests "
                "bool(active.any()) on the host every visit rank")
    if cfg.trace_scene_axis is not None \
            and axis_group(cfg.trace_scene_axis) is not None:
        return (f"trace_scene_axis {cfg.trace_scene_axis!r} names a process "
                "group: its trace merges are collectives")
    return None


def frames_entry(cfg: RadarModelConfig, device, batched: bool = True):
    """The frame entry a caller of `cfg` on `device` runs: the compiled
    one, or the eager one where the compiled one refuses cfg on the card
    (jit_refusal; said once a reason, as a warning)."""
    reason = jit_refusal(cfg) if torch.device(device).type == "cuda" \
        else None
    if reason is None:
        return simulate_frames_jit if batched else simulate_frame_jit
    warnings.warn(f"the compiled frame refuses this config ({reason}): "
                  "running the eager frame", stacklevel=2)
    return simulate_frames if batched else simulate_frame


def _frames_nograd(scene, cfg, params, *inputs) -> FrameResult:
    with torch.no_grad():
        return _frames(scene, params, cfg, *inputs)


# the frame graphs of the process (the jit cache of the reference's
# simulate_frames_jit), keyed on the scene's identity and shapes, cfg, and
# the arguments' structure, shapes and dtypes (Compiled.key)
frame_graphs = Compiled(_frames_nograd)


def _frame_args(params, poses, local_dirs, cone_draws, random_begin,
                uniform) -> tuple:
    """The compiled frame's arguments, in the dtypes the eager frame
    takes them in."""
    def f32(x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32)

    return (params, f32(poses), f32(local_dirs),
            None if cone_draws is None else tuple(map(f32, cone_draws)),
            None if random_begin is None else torch.as_tensor(random_begin),
            f32(uniform))


def _fetch_u8(res: FrameResult) -> FrameResult:
    """`res` with its u8 image moved to the host: one asynchronous copy on
    the current stream into a fresh page-locked tensor, then a wait on an
    event recorded after it (not on the whole device), so that the image
    is complete when the entry returns. PyTorch's caching host allocator
    hands a freed block out again only once its copy has finished, so no
    call writes into an earlier call's image, and after the first calls
    none pays for a new page-locked allocation. The span `rr.frame.fetch`;
    counted in simulate_frames_jit.host_fetches and .host_fetch_bytes."""
    u8 = res.image_u8
    with annotate("rr.frame.fetch"):
        host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(u8, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(u8.device))
        done.synchronize()
    simulate_frames_jit.host_fetches += 1
    simulate_frames_jit.host_fetch_bytes += host.numel()
    return res._replace(image_u8=host)


def simulate_frames_jit(scene: SceneTensors, params: RadarParams,
                        cfg: RadarModelConfig, poses, *,
                        local_dirs: Optional[torch.Tensor] = None,
                        cone_draws=None,
                        random_begin: Optional[torch.Tensor] = None,
                        uniform: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> FrameResult:
    """simulate_frames as one CUDA graph on the card (the reference's
    simulate_frames_jit), with its arguments and results; the results
    carry no autograd history (differentiate through
    opti.optimize.value_and_grad). On the card `image_u8` comes back on
    the host, page-locked and complete (_fetch_u8), while `image_float`
    and `max_val` stay on the card; on the CPU every field is the eager
    frame's.

    Absent random inputs are drawn from `generator` first, as
    simulate_frames draws them, so that both agree bit for bit on one
    seed. On the card the batch replays its graph in frame_graphs —
    captured on its first call, after an eager warm-up whose result that
    call returns (sim/graphs.py) — with the poses, random inputs and
    params copied in, then the u8 images fetched; a config jit_refusal
    names raises JitRefused before anything runs. On the CPU it is the
    eager frame. The call is the span `rr.frame.entry`, the fetch
    `rr.frame.fetch` inside it."""
    with annotate("rr.frame.entry"):
        return _frames_jit(scene, params, cfg, poses, local_dirs=local_dirs,
                           cone_draws=cone_draws, random_begin=random_begin,
                           uniform=uniform, generator=generator)


def _frames_jit(scene, params, cfg, poses, *, local_dirs, cone_draws,
                random_begin, uniform, generator) -> FrameResult:
    poses = torch.as_tensor(poses, dtype=torch.float32)
    args = _frame_args(params, poses, *_draw_absent(
        cfg, poses.shape[0], scene.device, local_dirs, cone_draws,
        random_begin, uniform, generator))
    reason = jit_refusal(cfg) if scene.device.type == "cuda" else None
    if reason is not None:
        raise JitRefused(f"simulate_frames_jit: {reason}; run "
                         "simulate_frames")
    res = frame_graphs(*args, static=(scene, cfg))
    return _fetch_u8(res) if res.image_u8.is_cuda else res


# compiled calls whose u8 images came back through a page-locked buffer,
# and those images' bytes (the card only)
simulate_frames_jit.host_fetches = 0
simulate_frames_jit.host_fetch_bytes = 0


def simulate_frame_jit(scene: SceneTensors, params: RadarParams,
                       cfg: RadarModelConfig, pose, *,
                       local_dirs: Optional[torch.Tensor] = None,
                       cone_draws=None,
                       random_begin: Optional[torch.Tensor] = None,
                       uniform: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> FrameResult:
    """simulate_frame through simulate_frames_jit (the reference's
    simulate_frame_jit): one frame, the batch of one, in one
    `rr.frame.entry` span; on the card its `image_u8` is a page-locked
    host tensor, as simulate_frames_jit's, counted there."""
    with annotate("rr.frame.entry"):
        return _one_frame(_frames_jit, scene, params, cfg, pose,
                          local_dirs=local_dirs, cone_draws=cone_draws,
                          random_begin=random_begin, uniform=uniform,
                          generator=generator)


def float_u8_image(res: FrameResult, cfg: RadarModelConfig) -> torch.Tensor:
    """Differentiable float stand-in for `image_u8` on the 0..255 scale: the
    same per-column normalization, clip and scroll without the rounding
    (|float_u8_image - image_u8| <= 0.5), shaped like image_u8."""
    mv = res.max_val
    pos = mv > 0.0
    scale = torch.where(pos, cfg.signal_max / torch.where(pos, mv, 1.0), 0.0)
    img = torch.clamp(res.image_float * scale[..., None], 0.0, 255.0)
    A = cfg.n_angles
    cols = (cfg.scroll_image + torch.arange(A, device=img.device)) % A
    placed = torch.zeros_like(img)
    placed[..., cols, :] = img
    return placed.transpose(-1, -2)
