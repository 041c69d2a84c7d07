"""Multi-device layouts of one radar frame on torch.distributed
(counterpart of radarays_ros_tpu/parallel/sharding.py).

Every rank of a mesh (parallel/groups.py) runs the same code on its own
device and its part of the work; every rank returns the global frame,
shaped as the unsharded `simulate_frame`'s.

  * azimuth (`simulate_frame_sharded`): rank a renders the azimuth rows
    [a A/n, (a+1) A/n) against the whole scene;
  * azimuth x sample (`simulate_frame_sharded_2d`): each rank renders its
    rows with its wedge of the cone's samples; the binned images are
    combined over "smp" before noise, a SUM for the linear denoise splat,
    a MAX for the per-cell max of signal_denoising=0;
  * scene (`simulate_frame_scene_sharded`): each rank holds a contiguous
    run of the scene's chunks (geom/scene.py:shard_scene_host) and traces
    every ray of the frame against it; every bounce merges the ranks'
    winners (trace/api.py:combine_trace_shards through
    cfg.trace_scene_axis);
  * azimuth x scene (`simulate_frame_sharded_az_scene`): both.

Random inputs. The frame's random draws are explicit inputs given to
every rank at full size: the cone's draws `cone_draws` = (theta, radial)
(S,) each, or its directions `local_dirs` (S, 3); the Perlin row offsets
`random_begin` (A,) where ambient_noise is 2; the uniform field `uniform`
(A, n_cells) where it is 1. Each rank cuts its wedge from them (samples
[s0, s0 + S_loc), rows [a0, a0 + A_loc) and their image columns), so a
layout's frame is the unsharded frame's ray for ray, up to the order of
the sample sum on "smp" and the trace's exact-distance ties across scene
shards.

Assembly. The wedges meet in one SUM all-reduce over "az" of zero-padded
full tensors as int32 bit patterns (x + 0 = x exactly, for -0.0 too);
the scroll is then placed on the assembled frame, as the reference places
it globally.

Every function takes the rank's resident scene tensors (the whole scene
for the azimuth layouts, the rank's shard for the scene layouts:
`scene_shard`), an explicit mesh and an explicit device; no function
picks a backend or a device by itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from radarays_ros_tpu_torch.geom.scene import (SceneHost, SceneTensors,
                                               scene_tensors, shard_scene_host)
from radarays_ros_tpu_torch.image.draw import (apply_ambient_noise,
                                               draw_signals, normalize_to_u8)
from radarays_ros_tpu_torch.parallel.groups import (Mesh, make_mesh,
                                                    make_mesh_2d,
                                                    make_mesh_az_scene,
                                                    make_mesh_scene,
                                                    scene_axis)
from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams)
from radarays_ros_tpu_torch.sim.pipeline import (FrameResult,
                                                 collect_signals,
                                                 simulate_frame, start_waves)
from radarays_ros_tpu_torch.wave.cone import cone_local
from radarays_ros_tpu_torch.wave.types import Waves

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "make_mesh_scene",
           "make_mesh_az_scene", "scene_shard", "wedge_waves",
           "simulate_frame_sharded", "simulate_frame_sharded_2d",
           "simulate_frame_scene_sharded", "simulate_frame_sharded_az_scene",
           "psnr_loss", "train_step_sharded"]


def scene_shard(host: SceneHost, mesh: Mesh, device,
                axis_name: str = "scene") -> SceneTensors:
    """This rank's shard of a host build along the mesh axis `axis_name`,
    uploaded to `device` (only the shard is uploaded)."""
    shards = shard_scene_host(host, mesh.shape[axis_name])
    return scene_tensors(shards[mesh.coords[axis_name]], device)


def _on(scene: SceneTensors, device) -> torch.device:
    dev = torch.device(device)
    if dev.type != scene.device.type or (dev.index is not None
                                         and dev != scene.device):
        raise ValueError(f"the scene lives on {scene.device}, not on {dev}")
    return scene.device


def _check_rows(cfg: RadarModelConfig, poses, n_az: int) -> None:
    """Refuse a mesh that does not divide the azimuths, and poses that are
    neither (7,) nor (n_angles, 7) (before any collective runs)."""
    shape = tuple(torch.as_tensor(poses).shape)
    if shape not in ((7,), (cfg.n_angles, 7)):
        raise ValueError(f"poses must be (7,) or ({cfg.n_angles}, 7), got "
                         f"{shape}")
    if cfg.n_angles % n_az:
        raise ValueError(f"n_angles {cfg.n_angles} must divide over the "
                         f"{n_az} ranks of the azimuth axis")


def _cone(params: RadarParams, cfg: RadarModelConfig, local_dirs, cone_draws,
          device) -> torch.Tensor:
    """The whole cone's beam-frame directions (S, 3): `local_dirs` as
    given, or built from `cone_draws` with the current beam width
    (differentiably, as start_waves does)."""
    if local_dirs is not None:
        return torch.as_tensor(local_dirs, dtype=torch.float32, device=device)
    if cone_draws is None:
        raise ValueError("a layout needs the cone's draws (cone_draws) or its "
                         "directions (local_dirs): every rank must hold the "
                         "same cone")
    theta, radial = (torch.as_tensor(x, dtype=torch.float32, device=device)
                     for x in cone_draws)
    return cone_local(theta, radial, params.beam_width, cfg.beam_sample_dist,
                      cfg.beam_sample_dist_normal_p_in_cone)


def _noise(cfg: RadarModelConfig, random_begin, uniform, device):
    """The noise inputs the config's mode takes, on device."""
    if cfg.ambient_noise == 2 and random_begin is None:
        raise ValueError("ambient_noise 2 needs random_begin (n_angles,)")
    if cfg.ambient_noise == 1 and uniform is None:
        raise ValueError("ambient_noise 1 needs uniform (n_angles, n_cells)")
    return (None if random_begin is None
            else torch.as_tensor(random_begin, device=device),
            None if uniform is None
            else torch.as_tensor(uniform, dtype=torch.float32, device=device))


def wedge_waves(params: RadarParams, cfg: RadarModelConfig, poses,
                local_dirs, rows: slice, samples: slice, device):
    """A wedge's start waves (1, A_loc, S_loc) and sensor positions
    (1, A_loc, 3): azimuth rows `rows` and cone samples `samples`, cut from
    the whole frame's (400 x 50 rays at the KAIST preset, cheap to make on
    every rank), so each ray is bit for bit the unsharded frame's."""
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    waves, sensor_pos = start_waves(params, cfg, poses[None],
                                    local_dirs=local_dirs, device=device)
    return (Waves(*(x[:, rows, samples] for x in waves)),
            sensor_pos[:, rows])


def _wedge_frame(scene, params, cfg_trace, cfg, poses, local_dirs, a0: int,
                 A_loc: int, s0: int, S_loc: int, random_begin, uniform,
                 img_combine=None):
    """Per-wedge frame body shared by the layouts (the reference's
    _wedge_frame): start waves -> bounces (cfg_trace, which may carry the
    scene axis) -> binned image -> optional combine across ranks before
    the noise (img_combine) -> column maxima -> energy scale -> ambient
    noise on the wedge's rows and image columns -> u8. Returns (u8 rows
    (A_loc, n_cells), image_float (A_loc, n_cells), max_val (A_loc,))."""
    A, n_cells = cfg.n_angles, cfg.n_cells
    dev = scene.device
    rows = slice(a0, a0 + A_loc)
    waves, sensor_pos = wedge_waves(params, cfg, poses, local_dirs, rows,
                                    slice(s0, s0 + S_loc), dev)
    times, strengths, valid = collect_signals(scene, params, cfg_trace,
                                              waves, sensor_pos)
    weights, mode = cfg.denoiser()
    img, _ = draw_signals(times[0], strengths[0], valid[0], n_cells=n_cells,
                          resolution=cfg.resolution, denoise_weights=weights,
                          denoise_mode=mode, method=cfg.draw_method)
    if img_combine is not None:
        img = img_combine(img)
    max_val = img.amax(dim=-1)
    img = img * cfg.energy_max                           # RadarCPU.cpp:453
    cols = (cfg.scroll_image + torch.arange(a0, a0 + A_loc, device=dev)) % A
    img = apply_ambient_noise(
        img, max_val, cols, mode=cfg.ambient_noise, resolution=cfg.resolution,
        at_signal_0=cfg.ambient_noise_at_signal_0,
        at_signal_1=cfg.ambient_noise_at_signal_1,
        energy_max=cfg.ambient_noise_energy_max,
        energy_min=cfg.ambient_noise_energy_min,
        energy_loss=cfg.ambient_noise_energy_loss,
        perlin_scale_low=cfg.ambient_noise_perlin_scale_low,
        perlin_scale_high=cfg.ambient_noise_perlin_scale_high,
        perlin_p_low=cfg.ambient_noise_perlin_p_low,
        random_begin=None if random_begin is None else random_begin[rows],
        uniform=None if uniform is None else uniform[rows])
    return normalize_to_u8(img, max_val, cfg.signal_max), img, max_val


def _assemble(cfg: RadarModelConfig, a0: int, u8_rows, img, max_val,
              group) -> FrameResult:
    """The global frame from the wedges of the azimuth group: zero-padded
    (A, 2 n_cells + 1) tensors of int32 bit patterns [image_float, max_val,
    u8] summed in one all-reduce (exact), then the scroll placed."""
    A, n_cells = cfg.n_angles, cfg.n_cells
    dev = img.device
    packed = torch.zeros((A, 2 * n_cells + 1), dtype=torch.int32, device=dev)
    packed[a0:a0 + img.shape[0]] = torch.cat(
        [img.detach().contiguous().view(torch.int32),
         max_val.detach().contiguous()[:, None].view(torch.int32),
         u8_rows.to(torch.int32)], dim=1)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    u8 = packed[:, n_cells + 1:].to(torch.uint8)
    # place azimuth a at column (scroll_image + a) % A (RadarCPU.cpp:457)
    cols = (cfg.scroll_image + torch.arange(A, device=dev)) % A
    placed = torch.zeros_like(u8)
    placed[cols] = u8
    return FrameResult(
        image_u8=placed.T.contiguous(),
        image_float=packed[:, :n_cells].contiguous().view(torch.float32),
        max_val=packed[:, n_cells].contiguous().view(torch.float32))


def _az_frame(scene, params, cfg_trace, cfg, poses, mesh: Mesh, *,
              local_dirs, cone_draws, random_begin, uniform, device,
              az_axis: str = "az",
              smp_axis: Optional[str] = None) -> FrameResult:
    """The wedge of this rank's rows along az_axis (and, with smp_axis,
    its sample wedge, combined over that axis before the noise), assembled
    over az_axis."""
    dev = _on(scene, device)
    n_az = mesh.shape[az_axis]
    _check_rows(cfg, poses, n_az)
    S = cfg.n_samples
    n_smp = 1 if smp_axis is None else mesh.shape[smp_axis]
    if S % n_smp:
        raise ValueError(f"n_samples {S} must divide over the {n_smp} ranks "
                         f"of the {smp_axis!r} axis")
    dirs = _cone(params, cfg, local_dirs, cone_draws, dev)
    rb, u = _noise(cfg, random_begin, uniform, dev)
    A_loc, S_loc = cfg.n_angles // n_az, S // n_smp
    a0 = mesh.coords[az_axis] * A_loc
    s0 = 0 if smp_axis is None else mesh.coords[smp_axis] * S_loc
    combine = None
    if smp_axis is not None:
        weights, _ = cfg.denoiser()
        op = dist.ReduceOp.SUM if weights is not None else dist.ReduceOp.MAX
        group = mesh.groups[smp_axis]

        def combine(img):
            img = img.detach().clone()
            dist.all_reduce(img, op=op, group=group)
            return img

    u8, img, max_val = _wedge_frame(scene, params, cfg_trace, cfg, poses,
                                    dirs, a0, A_loc, s0, S_loc, rb, u,
                                    img_combine=combine)
    return _assemble(cfg, a0, u8, img, max_val, mesh.groups[az_axis])


def simulate_frame_sharded(scene: SceneTensors, params: RadarParams,
                           cfg: RadarModelConfig, poses, mesh: Mesh, *,
                           local_dirs=None, cone_draws=None,
                           random_begin=None, uniform=None,
                           axis_name: str = "az",
                           device="cuda") -> FrameResult:
    """One frame with the azimuth rows split over the mesh axis
    `axis_name`; the scene and the parameters are replicated. poses: (7,)
    or (n_angles, 7), with n_angles a multiple of the axis size."""
    return _az_frame(scene, params, cfg, cfg, poses, mesh,
                     local_dirs=local_dirs, cone_draws=cone_draws,
                     random_begin=random_begin, uniform=uniform,
                     device=device, az_axis=axis_name)


def simulate_frame_sharded_2d(scene: SceneTensors, params: RadarParams,
                              cfg: RadarModelConfig, poses, mesh: Mesh, *,
                              local_dirs=None, cone_draws=None,
                              random_begin=None, uniform=None,
                              device="cuda") -> FrameResult:
    """One frame sharded over azimuth ("az") and beam samples ("smp"):
    every rank takes its sample wedge of the same whole cone, and the
    binned images meet over "smp" before the noise, by a SUM (the splat is
    linear) or, with signal_denoising=0, a MAX (RadarCPU.cpp:402-450 is a
    per-signal sum or max, so the combination is the frame's up to the
    order of the sum). n_samples must divide over "smp"."""
    return _az_frame(scene, params, cfg, cfg, poses, mesh,
                     local_dirs=local_dirs, cone_draws=cone_draws,
                     random_begin=random_begin, uniform=uniform,
                     device=device, smp_axis="smp")


def simulate_frame_scene_sharded(scene: SceneTensors, params: RadarParams,
                                 cfg: RadarModelConfig, poses, mesh: Mesh, *,
                                 local_dirs=None, cone_draws=None,
                                 random_begin=None, uniform=None,
                                 axis_name: str = "scene",
                                 device="cuda") -> FrameResult:
    """One frame with the SCENE sharded over the mesh axis `axis_name`:
    `scene` is this rank's shard (`scene_shard`), every rank traces all of
    the frame's rays against it, and each bounce merges the winners over
    the axis (cfg.trace_scene_axis). Shading, drawing and noise run on the
    same data in every rank, which returns the whole frame."""
    _on(scene, device)
    _check_rows(cfg, poses, 1)
    dirs = _cone(params, cfg, local_dirs, cone_draws, scene.device)
    rb, u = _noise(cfg, random_begin, uniform, scene.device)
    with scene_axis(axis_name, mesh.groups[axis_name]):
        return simulate_frame(
            scene, params, cfg.replace(trace_scene_axis=axis_name),
            torch.as_tensor(poses, dtype=torch.float32, device=scene.device),
            local_dirs=dirs, random_begin=rb, uniform=u)


def simulate_frame_sharded_az_scene(scene: SceneTensors, params: RadarParams,
                                    cfg: RadarModelConfig, poses,
                                    mesh: Mesh, *, local_dirs=None,
                                    cone_draws=None, random_begin=None,
                                    uniform=None,
                                    device="cuda") -> FrameResult:
    """One frame sharded over azimuth ("az") and the scene ("scene"):
    `scene` is this rank's shard along "scene" (`scene_shard`); each rank
    traces its azimuth rows against it, the winners merge over "scene"
    inside every bounce, and the wedges are assembled over "az"."""
    with scene_axis("scene", mesh.groups["scene"]):
        return _az_frame(scene, params, cfg.replace(trace_scene_axis="scene"),
                         cfg, poses, mesh, local_dirs=local_dirs,
                         cone_draws=cone_draws, random_begin=random_begin,
                         uniform=uniform, device=device)


def _neg_psnr(mse, signal_max: float):
    return -10.0 * torch.log10(torch.clamp_min(
        signal_max ** 2 / torch.clamp_min(mse, 1e-12), 1e-12))


def psnr_loss(image_float, target_float, signal_max: float):
    """Negative PSNR against a target float image (both (A, n_cells))."""
    return _neg_psnr(torch.mean((image_float - target_float) ** 2),
                     signal_max)


def sharded_loss_and_grads(scene: SceneTensors, params: RadarParams,
                           cfg: RadarModelConfig, poses, target, mesh: Mesh,
                           *, local_dirs=None, cone_draws=None,
                           random_begin=None, uniform=None,
                           axis_name: str = "az", device="cuda"):
    """The global -PSNR of the frame against `target` (n_angles, n_cells)
    and its gradients w.r.t. the material table and the beam width (the
    latter through the cone draws), each rank rendering its azimuth rows.

    The loss is one function of the whole image, mse = SSE / (A n_cells):
    the ranks' squared-error sums meet in one SUM all-reduce, each rank
    backpropagates dL/dSSE x its own sum, and the gradients meet in a
    second SUM — the chain rule of the global loss (the mean of the ranks'
    own losses would be another function). Returns (loss, (materials
    gradients as a Materials, beam-width gradient)), equal on every rank."""
    dev = _on(scene, device)
    n_az, group = mesh.shape[axis_name], mesh.groups[axis_name]
    _check_rows(cfg, poses, n_az)
    A, n_cells, S = cfg.n_angles, cfg.n_cells, cfg.n_samples
    A_loc = A // n_az
    a0 = mesh.coords[axis_name] * A_loc
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (*params.materials, params.beam_width)]
    p = params._replace(materials=Materials(*leaves[:4]),
                        beam_width=leaves[4])
    dirs = _cone(p, cfg, local_dirs, cone_draws, dev)
    rb, u = _noise(cfg, random_begin, uniform, dev)
    _, img, _ = _wedge_frame(scene, p, cfg, cfg, poses, dirs, a0, A_loc, 0,
                             S, rb, u)
    tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
    sse = torch.sum((img - tgt[a0:a0 + A_loc]) ** 2)
    total = sse.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    total.requires_grad_(True)
    loss = _neg_psnr(total / (A * n_cells), cfg.signal_max)
    (d_sse,) = torch.autograd.grad(loss, total)
    grads = torch.autograd.grad(d_sse * sse, leaves, allow_unused=True)
    flat = torch.cat([(torch.zeros_like(x) if g is None else g).reshape(-1)
                      for g, x in zip(grads, leaves)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    M = params.materials.n
    mats = Materials(*flat[:4 * M].view(4, M))
    return loss.detach(), (mats, flat[4 * M].reshape(()))


def train_step_sharded(scene: SceneTensors, params: RadarParams,
                       cfg: RadarModelConfig, poses, target, mesh: Mesh, *,
                       lr: float = 1e-3, local_dirs=None, cone_draws=None,
                       random_begin=None, uniform=None,
                       axis_name: str = "az", device="cuda"):
    """One SGD step of the -PSNR objective over the azimuth mesh (the
    reference's train_step_sharded): the gradients are those of the global
    loss (`sharded_loss_and_grads`). Returns (loss, new params)."""
    loss, (g_mat, g_bw) = sharded_loss_and_grads(
        scene, params, cfg, poses, target, mesh, local_dirs=local_dirs,
        cone_draws=cone_draws, random_begin=random_begin, uniform=uniform,
        axis_name=axis_name, device=device)
    return loss, params._replace(
        materials=Materials(*(x.detach() - lr * g
                              for x, g in zip(params.materials, g_mat))),
        beam_width=params.beam_width.detach() - lr * g_bw)
