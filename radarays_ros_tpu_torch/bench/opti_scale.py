"""Material fitting at workload scale, gradient against black-box (the twin
of the JAX repo's benchmarks/opti_scale.py).

    python -m radarays_ros_tpu_torch.bench.opti_scale [--device cpu]
        [--steps 60] [--buildings 200] [--frames 3] [--target-db 40]
        [--margin DB] [--checkpoint build/opti_scale_torch_ck.npz]
        [--fixed-beam-width]

The recovery problem of the reference's fit (scripts/radaray_opti.py): an
urban scene (make_urban_scene(n, 150, seed=11), wall on the buildings,
"glass" on the ground), a circular trajectory of --frames poses, targets
rendered at the true parameters, and a 9-dim vector (beam width and both
material slots) fitted from a perturbed start on the multi-frame -PSNR:

  * gradient: Adam through the differentiable frame (opti/optimize.py:
    optimize_gradient), --steps split in two halves around a checkpoint
    saved and loaded through opti/checkpoint.py (lr 0.08, then 0.04);
  * black-box: optimize_black_box on the same objective, the reference's
    seeds and iterations.

Scores the evaluations until the loss reaches the target (--target-db,
or with --margin the true parameters' PSNR less that many dB) and the wall
time. One JSON line a phase; the gradient line also carries the gradient
at the start (`start_gradient`). The cone draws of each frame come from a
torch.Generator seeded with 3 (the reference's key) and are held fixed
across evaluations, as the reference holds its keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C

AIR = C.AIR
TRUE_MATS = [AIR, dict(velocity=0.0, ambient=0.85, diffuse=0.15,
                       specular=900.0),
             dict(velocity=0.0, ambient=0.35, diffuse=0.6, specular=150.0)]
START_MATS = [AIR, dict(velocity=0.0, ambient=0.3, diffuse=0.6,
                        specular=150.0),
              dict(velocity=0.0, ambient=0.9, diffuse=0.05,
                   specular=2000.0)]
# opti_scale.py:84-92; the optimizer explores nonzero velocities, so the
# opaque fast path stays off
CFG = dict(n_angles=200, n_cells=1024, resolution=0.125, n_samples=12,
           n_reflections=2, beam_sample_dist=2, energy_max=0.72,
           signal_max=110.0, signal_denoising=1,
           signal_denoising_triangular_width=17,
           signal_denoising_triangular_mode=0.35, ambient_noise=0,
           record_multi_reflection=True, opaque_materials=False)


def fit_setup(n_buildings: int, n_frames: int, device, *,
              cfg_overrides: Optional[dict] = None, cone_draws=None,
              extent: float = 150.0) -> dict:
    """The scene, true and start parameters, config, poses, cone draws
    ((theta, radial) each (n_frames, S); drawn from a generator seeded
    with 3 unless given), the parameter vector and the targets."""
    from radarays_ros_tpu_torch.io.trajectory import Trajectory
    from radarays_ros_tpu_torch.opti.optimize import ParamVector
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.sim.pipeline import (float_u8_image,
                                                     frames_entry)
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    dev = torch.device(device)
    scene = C.urban_scene(n_buildings, extent, 11)
    st = scene.to_device(dev)
    om = np.ones(scene.n_objects, np.int32)
    om[0] = 2                                      # the ground

    def params(mats, deg):
        return RadarParams.make(Materials.from_list(mats, device=dev), om,
                                beam_width_deg=deg)

    cfg = RadarModelConfig(**CFG).replace(**(cfg_overrides or {}))
    traj = Trajectory.circular(radius=25.0, n=n_frames, period=8.0)
    poses = np.stack([traj.pose_at(t) + np.array([0, 0, 2.0, 0, 0, 0, 0],
                                                  np.float32)
                      for t in traj.stamps]).astype(np.float32)
    if cone_draws is None:
        gen = torch.Generator(dev).manual_seed(3)
        draws = [sample_cone_draws(gen, cfg.n_samples, cfg.beam_sample_dist)
                 for _ in range(n_frames)]
        cone_draws = tuple(torch.stack(d) for d in zip(*draws))
    cone_draws = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                       for x in cone_draws)
    true = params(TRUE_MATS, 10.0)
    poses = torch.from_numpy(poses)
    with torch.no_grad():
        targets = float_u8_image(frames_entry(cfg, dev)(
            st, true, cfg, poses, cone_draws=cone_draws), cfg)
    return dict(scene=st, true=true, start=params(START_MATS, 7.0), cfg=cfg,
                poses=poses, cone_draws=cone_draws, targets=targets,
                pv=ParamVector(material_slots=(1, 2),
                               tune_n_reflections=False,
                               tune_beam_width=True))


def gradient_fit(objective, start, pv, steps: int,
                 checkpoint: Optional[str], device) -> tuple:
    """optimize_gradient in two halves (lr 0.08, then 0.04 from the first
    half's best parameters); with `checkpoint` those pass through a saved
    and loaded checkpoint. Returns (the loss history, the step resumed
    from)."""
    from radarays_ros_tpu_torch.opti.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from radarays_ros_tpu_torch.opti.optimize import optimize_gradient

    half = max(steps // 2, 1)
    res1 = optimize_gradient(objective, start, pv, steps=half, lr=0.08)
    resumed, step = res1.params, half
    if checkpoint is not None:
        Path(checkpoint).parent.mkdir(parents=True, exist_ok=True)
        save_checkpoint(checkpoint, res1.params, vec=res1.vec,
                        history=res1.history, step=half)
        resumed, extras = load_checkpoint(checkpoint, device=device)
        step = int(extras["step"])
    res2 = optimize_gradient(objective, resumed, pv, steps=steps - half,
                             lr=0.04)
    return list(res1.history) + list(res2.history), step


def start_gradient(objective, start, pv, h: float = 1e-2) -> dict:
    """The gradient Adam takes first: the loss's gradient at the start in
    the reparameterized vector z that optimize_gradient descends, and, when
    the beam width is tuned (z[0]), its central difference (step h in z)
    beside it. The beam width's analytic gradient misses the binning floor
    (the reference's too), and Adam scales each entry to a step of lr
    whatever its size, so a wrong sign there costs every step."""
    from radarays_ros_tpu_torch.opti.optimize import step_loss_fn

    step_loss, _, to_z = step_loss_fn(objective, start, pv)
    z = to_z(pv.to_vec(start)).requires_grad_(True)
    step_loss(z).backward()
    g = z.grad.detach()
    out = {"start_grad": g.tolist(), "start_grad_norm": float(g.norm())}
    if pv.tune_beam_width:
        with torch.no_grad():
            e = torch.zeros_like(z)
            e[0] = h
            out["beam_width_central_difference"] = (
                float(step_loss(z + e)) - float(step_loss(z - e))) / (2 * h)
    return out


def evals_to_target(history, target_loss: float):
    return next((i + 1 for i, v in enumerate(history) if v <= target_loss),
                None)


def main(argv=None, *, cfg_overrides: Optional[dict] = None,
         cone_draws=None, extent: float = 150.0) -> list:
    """cfg_overrides, cone_draws and extent cut the run to size and fix
    its draws (tests). Returns the printed records."""
    from radarays_ros_tpu_torch.opti.optimize import (compiled,
                                                      default_objective,
                                                      optimize_black_box)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    C.add_device_arg(ap)
    ap.add_argument("--buildings", type=int, default=200)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--target-db", type=float, default=40.0)
    ap.add_argument("--margin", type=float, default=None,
                    help="score against the true parameters' PSNR less "
                         "this many dB instead of --target-db")
    ap.add_argument("--checkpoint",
                    default=str(C.BUILD / "opti_scale_torch_ck.npz"))
    ap.add_argument("--fixed-beam-width", action="store_true",
                    help="tune the materials only, the beam width held at "
                         "the start's, as the CLI's optimize does (see "
                         "start_gradient)")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    s = fit_setup(args.buildings, args.frames, dev,
                  cfg_overrides=cfg_overrides, cone_draws=cone_draws,
                  extent=extent)
    out = [C.emit({"device": C.card_identity(dev),
                   "n_triangles": s["scene"].n_triangles})]
    objective = default_objective(s["scene"], s["cfg"], s["poses"],
                                  s["targets"], cone_draws=s["cone_draws"])
    # the loss compiled where the reference jits it (its
    # benchmarks/opti_scale.py:115, 160)
    true_db = -float(compiled(objective)(s["true"]))
    target_db = (true_db - args.margin if args.margin is not None
                 else args.target_db)
    out.append(C.emit({"true_loss_db": true_db, "target_psnr_db": target_db}))

    if args.fixed_beam_width:
        s["pv"] = dataclasses.replace(s["pv"], tune_beam_width=False)
    grad0 = start_gradient(objective, s["start"], s["pv"])
    C.fence(dev)
    C.zero_launches()
    t0 = time.perf_counter()
    hist, step = gradient_fit(objective, s["start"], s["pv"], args.steps,
                              args.checkpoint, dev)
    C.fence(dev)
    wall = time.perf_counter() - t0
    if not all(map(math.isfinite, hist)):
        raise RuntimeError(f"non-finite loss in the gradient fit: {hist}")
    out.append(C.emit({
        "bench": "opti_gradient", "steps": args.steps,
        "beam_width_tuned": s["pv"].tune_beam_width,
        "start_psnr_db": -hist[0], "final_psnr_db": -min(hist),
        "evals_to_target": evals_to_target(hist, -target_db),
        "resumed_from_step": step, "wall_s": wall,
        "steps_per_s": args.steps / wall,
        "kernel_launches": C.read_launches(), **grad0, "history": hist}))

    pv, start = s["pv"], s["start"]

    loss_of_vec = compiled(lambda v: objective(pv.to_params(start, v)[0]))

    def f(v):
        return float(loss_of_vec(torch.as_tensor(v, dtype=torch.float32,
                                                 device=dev)))

    C.zero_launches()
    t0 = time.perf_counter()
    _, bb_best, bb_hist = optimize_black_box(
        f, pv.bounds(), n_seeds=max(args.steps // 4, 4), iters=args.steps,
        seed=1, x0=pv.to_vec(start))
    wall = time.perf_counter() - t0
    out.append(C.emit({
        "bench": "opti_black_box", "evaluations": len(bb_hist),
        "final_psnr_db": -bb_best,
        "evals_to_target": evals_to_target(bb_hist, -target_db),
        "wall_s": wall, "evaluations_per_s": len(bb_hist) / wall,
        "kernel_launches": C.read_launches()}))
    return out


if __name__ == "__main__":
    main()
