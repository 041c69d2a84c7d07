"""Command-line entry points — the reference's ROS nodes as CLI tools
(counterpart of radarays_ros_tpu/io/cli.py).

`python -m radarays_ros_tpu_torch.io.cli <command>`:

  * `simulate`    — the `radar_simulator` node (src/radar_simulator.cpp
                    :98-224): load mesh + scene config + preset, then either
                    free-run N frames at a fixed pose/trajectory (the 100 Hz
                    loop, radar_simulator.cpp:195-213) or sync-replay the
                    stamps of a trajectory file (sync_topic mode,
                    radar_simulator.cpp:83-96). Frames go to PNG/NPY files.
  * `rays`        — the `ray_reflection_test` debug node
                    (src/ray_reflection_test.cpp:169-354): trace one beam (or
                    a 360-degree fan / sampled cone) for B bounces and dump
                    the per-bounce segments with energy + medium to JSON.
  * `info`        — mesh/scene statistics (objects, triangles, chunks).
  * `prime-cache` — build + persist a mesh's host build (geom/cache.py).
  * `optimize`    — fit material properties to a target frame.
  * `eval`        — real-vs-sim metrics, dir-vs-dir or stamp-synced.
  * `render`      — paper-style cartesian view of a polar frame + stats.
  * `explore`     — the 2-D physics explorer panels (viz/explore.py): brdf,
                    fresnel, slab and beams as JSON, a figure, or live
                    sliders.

Arguments, defaults and printed lines are the reference's, with one more
argument, `--device` (default cuda): torch needs the device named where
JAX picks its platform itself. A CUDA device that is not there is an
error; the commands never fall back to the CPU (`--device cpu` runs the
kernels' plain versions). `--engine` also takes the reference's names
(pallas3 = kernel, culled = sweep; mxu is mxu).

Examples:
  python -m radarays_ros_tpu_torch.io.cli simulate --mesh scene.ply \\
      --scene-config materials.yaml --preset mulran_kaist_dyncfg.yaml \\
      --frames 10 --out out/
  python -m radarays_ros_tpu_torch.io.cli rays --mesh scene.ply --yaw 0.3 \\
      --bounces 4 --out rays.json --device cpu
  python -m radarays_ros_tpu_torch.io.cli explore --panel fresnel \\
      --v1 0.3 --v2 0.15 --json fresnel.json --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

_log = logging.getLogger(__name__)


class CliError(Exception):
    """A command-line error: printed to stderr, exit code 2."""


def _device(args):
    """The torch device of --device; a CUDA device that is not present is
    an error, never a fallback to the CPU."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"--device {args.device}: no CUDA device is available"
                       " (pass --device cpu to run on the CPU)")
    return dev


def _load_scene(args):
    from radarays_ros_tpu_torch.geom.mesh import load_mesh

    t0 = time.perf_counter()
    scene = load_mesh(args.mesh, chunk_size=args.chunk_size)
    _log.info("mesh: %s, %d triangles, loaded in %.3f s", args.mesh,
              scene.n_triangles, time.perf_counter() - t0)
    return scene


def _load_cfg_params(args, scene):
    import torch

    from radarays_ros_tpu_torch.io.config import load_preset, load_scene_config
    from radarays_ros_tpu_torch.sim.config import (
        Materials, RadarModelConfig, RadarParams, port_engine)

    beam_width_deg = 8.0
    if args.scene_config:
        sc = load_scene_config(args.scene_config)
        obj_mat = sc.object_materials
        if obj_mat.shape[0] < scene.n_objects:
            obj_mat = np.concatenate([
                obj_mat,
                np.zeros(scene.n_objects - obj_mat.shape[0], np.int32)])
        params = RadarParams.make(sc.materials, obj_mat, beam_width_deg)
        air = sc.material_id_air
    else:
        params = RadarParams.make(
            Materials.air_only(),
            np.zeros(max(scene.n_objects, 1), np.int32), beam_width_deg)
        air = 0

    try:
        if args.preset:
            cfg, bw, _ = load_preset(args.preset)
            # trace_aux_baked describes scene tensors, not a preset: the
            # commands upload unbaked scenes, and Radar sets it as it bakes
            cfg = cfg.replace(material_id_air=air, trace_aux_baked=False)
            if bw is not None:
                params = params._replace(beam_width=torch.tensor(
                    np.float32(np.deg2rad(bw))))
        else:
            cfg = RadarModelConfig(material_id_air=air)
        if args.engine:
            cfg = cfg.replace(trace_engine=port_engine(args.engine))
    except ValueError as e:
        raise CliError(str(e)) from e
    return cfg, params


def cmd_simulate(args) -> int:
    import torch

    from radarays_ros_tpu_torch.io.image_io import save_frame
    from radarays_ros_tpu_torch.io.trajectory import Trajectory
    from radarays_ros_tpu_torch.sim.radar import Radar
    from radarays_ros_tpu_torch.utils.transforms import identity_pose

    # validate the argument combination before the scene build: a doomed
    # --synced run must not pay for a large scene's host build first
    if args.synced and not args.traj:
        print("--synced requires --traj", file=sys.stderr)
        return 2
    dev = _device(args)

    scene = _load_scene(args)
    cfg, params = _load_cfg_params(args, scene)
    radar = Radar(scene, params, cfg, seed=args.seed, device=dev)

    traj = Trajectory.load_tum(args.traj) if args.traj else None
    if args.synced:
        stamps = traj.stamps[:args.frames] if args.frames else traj.stamps
    else:
        stamps = np.arange(args.frames, dtype=np.float64) / args.rate

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fmt = args.format

    if args.batch > 1:
        # throughput mode: multi-frame batches through the compiled frame
        # (simulate_frames_jit, as the reference's), the random draws from
        # one generator seeded with --seed
        from radarays_ros_tpu_torch.sim.pipeline import frames_entry

        frames = frames_entry(radar.cfg, dev)

        t_start = time.perf_counter()
        gen = torch.Generator(dev).manual_seed(args.seed)
        done = 0
        B = args.batch
        pad_stamps = np.concatenate(
            [stamps, np.repeat(stamps[-1:], (-len(stamps)) % B)])
        for base in range(0, len(pad_stamps), B):
            batch_stamps = pad_stamps[base:base + B]
            if traj is not None:
                poses = traj.poses_at(batch_stamps)
            else:
                poses = np.tile(identity_pose(), (B, 1))
            with torch.no_grad():
                res = frames(radar._scene_tensors, radar.params, radar.cfg,
                             torch.from_numpy(poses), generator=gen)
            imgs = res.image_u8.cpu().numpy()
            for j in range(B):
                if done >= len(stamps):
                    break
                save_frame(out / f"frame_{done:05d}.{fmt}", imgs[j])
                done += 1
        total = time.perf_counter() - t_start
        n = max(len(stamps), 1)
        print(f"{n} frames (batched x{B}) in {total:.2f} s -> "
              f"{n / total:.2f} Hz")
        return 0

    t_start = time.perf_counter()
    for i, stamp in enumerate(stamps):
        if traj is not None:
            if cfg.include_motion:
                pose = traj.poses_for_scan(stamp, args.scan_duration,
                                           cfg.n_angles)
            else:
                pose = traj.pose_at(stamp)
        else:
            pose = identity_pose()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = radar.simulate_image(pose)
        dt = time.perf_counter() - t0
        save_frame(out / f"frame_{i:05d}.{fmt}", img)
        # per-frame wall time, as printed by the reference (RadarCPU.cpp:550)
        print(f"frame {i:5d} stamp {stamp:.3f}  {dt * 1e3:8.2f} ms")
    total = time.perf_counter() - t_start
    n = max(len(stamps), 1)
    print(f"{n} frames in {total:.2f} s -> {n / total:.2f} Hz")
    return 0


def cmd_rays(args) -> int:
    from radarays_ros_tpu_torch.io.trajectory import Trajectory
    from radarays_ros_tpu_torch.utils.transforms import identity_pose
    from radarays_ros_tpu_torch.viz.rays import trace_debug_rays

    dev = _device(args)
    scene = _load_scene(args)
    cfg, params = _load_cfg_params(args, scene)
    params = params.to(dev)
    pose = (Trajectory.load_tum(args.traj).pose_at(args.stamp)
            if args.traj else identity_pose())

    mode = ("fan" if args.all_directions else
            ("cone" if args.cone else "single"))
    st = scene.to_device(dev)
    if args.spin > 1:
        # the spinning mode of RayReflection.cfg: sweep the beam yaw and
        # collect every shot's segments (yaw tagged per segment)
        result = {"segments": [], "n_rays": 0}
        for k in range(args.spin):
            yaw = args.yaw + k * args.yaw_increment
            shot = trace_debug_rays(st, params, cfg, pose, yaw=yaw,
                                    n_bounces=args.bounces, mode=mode,
                                    n_fan=args.n_fan, seed=args.seed)
            for seg in shot["segments"]:
                seg["yaw"] = round(yaw, 6)
            result["segments"] += shot["segments"]
            result["n_rays"] += shot["n_rays"]
    else:
        result = trace_debug_rays(
            st, params, cfg, pose,
            yaw=args.yaw, n_bounces=args.bounces, mode=mode,
            n_fan=args.n_fan, seed=args.seed,
        )
    payload = json.dumps(result, indent=None if args.compact else 2)
    if args.out:
        Path(args.out).write_text(payload)
        print(f"wrote {args.out}: {len(result['segments'])} segments")
    else:
        print(payload)
    return 0


def cmd_info(args) -> int:
    """Host-side statistics: the chunk count comes from the host build, so
    no device is involved and --device is not read."""
    scene = _load_scene(args)
    host = scene.host_arrays()
    print(f"mesh:      {args.mesh}")
    print(f"triangles: {scene.n_triangles}")
    print(f"objects:   {scene.n_objects}")
    if scene.object_names:
        for i, n in enumerate(scene.object_names):
            count = int(np.sum(scene.obj_ids == i))
            print(f"  {i:3d}: {n} ({count} tris)")
    print(f"chunks:    {host.chunk_lo.shape[0]} x {host.chunk_size}")
    lo = scene.verts.reshape(-1, 3).min(0)
    hi = scene.verts.reshape(-1, 3).max(0)
    print(f"aabb:      {lo.tolist()} .. {hi.tolist()}")
    return 0


def cmd_optimize(args) -> int:
    """Material-property fitting — the radaray_opti.py workflow as a CLI.

    Loads a target polar frame, then minimizes -PSNR(sim, target) over the
    selected material slots by gradient descent through the differentiable
    frame (default) or by the derivative-free fallback. The frame's random
    draws come once from a generator seeded with --seed and stay fixed
    across evaluations. Checkpoints are resumable; the result can be
    written back as a reference-format scene YAML."""
    import torch

    from radarays_ros_tpu_torch.io.config import save_scene_config
    from radarays_ros_tpu_torch.io.image_io import read_png_gray
    from radarays_ros_tpu_torch.io.trajectory import Trajectory
    from radarays_ros_tpu_torch.opti.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from radarays_ros_tpu_torch.opti.optimize import (
        ParamVector, compiled, default_objective, optimize_black_box,
        optimize_gradient)
    from radarays_ros_tpu_torch.utils.transforms import (identity_pose,
                                                         make_pose)

    dev = _device(args)
    scene = _load_scene(args)
    cfg, params = _load_cfg_params(args, scene)
    params = params.to(dev)
    target_path = Path(args.target)
    target = (np.load(target_path) if target_path.suffix == ".npy"
              else read_png_gray(target_path))
    if target.shape != (cfg.n_cells, cfg.n_angles):
        print(f"target shape {target.shape} != frame "
              f"({cfg.n_cells}, {cfg.n_angles})", file=sys.stderr)
        return 2

    if args.checkpoint and Path(args.checkpoint).exists():
        params, extras = load_checkpoint(args.checkpoint, device=dev)
        print(f"resumed checkpoint at step {extras['step']}")

    pose = (make_pose([float(v) for v in args.pose.split(",")])
            if args.pose else identity_pose())
    if args.traj:
        pose = Trajectory.load_tum(args.traj).pose_at(0.0)
    st = scene.to_device(dev)
    slots = tuple(int(s) for s in args.slots.split(","))
    pv = ParamVector(material_slots=slots, tune_n_reflections=False,
                     tune_beam_width=False)
    # loss on the differentiable u8-scale float image (image_u8 is rounded,
    # its gradient is zero), random draws fixed across evaluations
    loss_of_params = default_objective(
        st, cfg, torch.from_numpy(pose), target,
        generator=torch.Generator(dev).manual_seed(args.seed))

    # compiled as the reference jits them (its io/cli.py:275-284)
    init_loss = float(compiled(loss_of_params)(params))
    print(f"initial PSNR {-init_loss:.3f} dB")

    if args.method == "gradient":
        res = optimize_gradient(loss_of_params, params, pv,
                                steps=args.steps, lr=args.lr, verbose=True)
        vec, value, history = res.vec, res.value, res.history
        fitted = res.params
    else:
        loss_of_vec = compiled(
            lambda v: loss_of_params(pv.to_params(params, v)[0]))

        def f(v):
            return float(loss_of_vec(torch.as_tensor(v, dtype=torch.float32,
                                                     device=dev)))

        vec, value, history = optimize_black_box(
            f, pv.bounds(), n_seeds=max(args.steps // 4, 4),
            iters=args.steps, seed=args.seed, x0=pv.to_vec(params))
        fitted, _ = pv.to_params(params, vec)

    print(f"final PSNR {-value:.3f} dB over {len(history)} evaluations")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, fitted, vec=vec, history=history,
                        step=len(history))
        print(f"checkpoint -> {args.checkpoint}")
    if args.out_config:
        save_scene_config(args.out_config, fitted.materials,
                          fitted.object_materials,
                          material_id_air=cfg.material_id_air)
        print(f"fitted materials -> {args.out_config}")
    return 0


def cmd_eval(args) -> int:
    """Two modes (eval_real_to_sim.launch workflow):

    * --real DIR --sim DIR       pairwise comparison of two frame dirs
                                 (host frames, metrics on CPU tensors);
    * --real DIR --mesh ... --traj ...
                                 stamp-synced real-vs-sim: simulate at each
                                 real frame's stamp on --device (sync_topic
                                 mode, radar_simulator.cpp:83-96) and score.
    """
    from radarays_ros_tpu_torch.opti.evaluate import (evaluate_dirs,
                                                      evaluate_real_vs_sim)

    metrics = args.metrics.split(",")
    if args.sim:
        report = evaluate_dirs(args.real, args.sim, metrics=metrics,
                               limit=args.limit)
    else:
        if not (args.mesh and args.traj):
            print("eval needs either --sim DIR, or --mesh + --traj for "
                  "stamp-synced real-vs-sim", file=sys.stderr)
            return 2
        from radarays_ros_tpu_torch.io.realdata import RealFrameSequence
        from radarays_ros_tpu_torch.io.trajectory import Trajectory

        dev = _device(args)
        scene = _load_scene(args)
        cfg, params = _load_cfg_params(args, scene)
        real = RealFrameSequence(args.real, stamps_file=args.stamps,
                                 transpose=args.real_transpose)
        traj = Trajectory.load_tum(args.traj)
        report = evaluate_real_vs_sim(
            real, scene.to_device(dev), params.to(dev), cfg, traj,
            metrics=metrics, limit=args.limit, seed=args.seed)
        print(f"sync error: mean {report['sync_error_s']['mean'] * 1e3:.1f} "
              f"ms  max {report['sync_error_s']['max'] * 1e3:.1f} ms"
              f"  ({report['out_of_traj']} frames outside the trajectory)")

    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
    for m, s in report["summary"].items():
        print(f"{m}: mean {s['mean']:.4f}  std {s['std']:.4f}  "
              f"[{s['min']:.4f}, {s['max']:.4f}]  over {report['n_frames']} "
              "frames")
    return 0


def cmd_explore(args) -> int:
    """The reference's 2-D physics explorers (scripts/reflections/,
    radaray_beams.py, radarays_snell_fresnel_brdf.py) as one tool: a
    panel's data as JSON and, with --plot, a figure (matplotlib, imported
    only then); --interactive opens live sliders. The data runs the port's
    wave physics on --device."""
    from radarays_ros_tpu_torch.viz import explore

    if args.interactive and args.panel not in explore._INTERACTIVE:
        print(f"panel {args.panel!r} has no interactive mode "
              f"(available: {sorted(explore._INTERACTIVE)})",
              file=sys.stderr)
        return 2
    dev = _device(args)
    if args.interactive:
        fn = explore._INTERACTIVE[args.panel]
        if args.panel == "brdf":
            fn(args.ambient, args.diffuse, args.specular, device=dev)
        elif args.panel == "fresnel":
            fn(args.v1, args.v2, args.polarization, device=dev)
        else:
            fn(args.beam_width, args.n_samples, args.p_in_cone, args.seed,
               device=dev)
        import matplotlib.pyplot as plt
        plt.show()
        return 0

    plot = bool(args.plot)
    if args.panel == "brdf":
        data, fig = explore.panel_brdf(args.ambient, args.diffuse,
                                       args.specular, plot=plot, device=dev)
    elif args.panel == "fresnel":
        data, fig = explore.panel_fresnel(args.v1, args.v2,
                                          args.polarization, plot=plot,
                                          device=dev)
    elif args.panel == "slab":
        depths = [float(x) for x in args.depths.split(",")]
        vels = [float(x) for x in args.velocities.split(",")]
        direction = tuple(float(x) for x in args.direction.split(","))
        origin = tuple(float(x) for x in args.origin.split(","))
        data, fig = explore.panel_slab(
            depths, vels, origin=origin, direction=direction,
            n_bounces=args.bounces, polarization=args.polarization,
            plot=plot, device=dev)
    else:  # beams
        data, fig = explore.panel_beams(args.beam_width, args.n_samples,
                                        args.p_in_cone, args.seed, plot=plot,
                                        device=dev)
    if args.json:
        Path(args.json).write_text(json.dumps(data))
        print(f"wrote {args.json}")
    if plot:
        if fig is None:
            print("matplotlib unavailable; --plot skipped", file=sys.stderr)
            return 1
        fig.savefig(args.plot)
        print(f"wrote {args.plot}")
    if not args.json and not plot:
        print(json.dumps(data))
    return 0


def cmd_render(args) -> int:
    """Paper-style cartesian rendering of a polar frame (the view of the
    reference's published result, dat/kaist02_radarays_papercolor.png),
    plus an optional statistical comparison against a reference image
    (viz/cartesian.py). NumPy on the host."""
    from radarays_ros_tpu_torch.io.image_io import (
        read_image_gray, read_png_gray, write_png_gray, write_png_rgb)
    from radarays_ros_tpu_torch.viz.cartesian import (
        cartesian_stats, colorize_papercolor, compare_imaging_stats,
        imaging_stats, polar_to_cartesian, stretch_contrast)

    polar = read_png_gray(args.frame) if args.frame.endswith(".png") \
        else np.load(args.frame)
    max_cell = None
    if args.max_range is not None:
        max_cell = int(round(args.max_range / args.resolution))
    cart = polar_to_cartesian(polar, size=args.size, max_cell=max_cell,
                              scroll=args.scroll)
    if args.stretch:
        cart = stretch_contrast(cart)
    if args.out:
        if args.color:
            write_png_rgb(args.out, colorize_papercolor(cart))
        else:
            write_png_gray(args.out, cart)
        print(f"wrote {args.out}")

    report = {"polar_stats": imaging_stats(
        polar, noise_threshold=args.noise_threshold)}
    if args.against_polar:
        # polar-to-polar statistics against a (cropped) reference polar
        # panel; our frame is cropped to the same range-row count
        ref = read_image_gray(args.against_polar)
        if args.against_crop:
            x0, y0, x1, y1 = (int(v) for v in args.against_crop.split(","))
            ref = ref[y0:y1, x0:x1]
        sim_rows = polar[:ref.shape[0]]
        ref_stats = imaging_stats(ref, noise_threshold=args.noise_threshold)
        sim_stats = imaging_stats(sim_rows,
                                  noise_threshold=args.noise_threshold)
        report["reference_polar_stats"] = ref_stats
        report["sim_polar_stats_cropped"] = sim_stats
        report["polar_comparison"] = compare_imaging_stats(sim_stats,
                                                           ref_stats)
        for k, v in report["polar_comparison"].items():
            print(f"polar {k}: {v:.4f}")
    if args.against_image:
        ref = read_image_gray(args.against_image)
        center = None
        if args.against_center:
            cx, cy = (float(x) for x in args.against_center.split(","))
            center = (cy, cx)
        ref_stats = cartesian_stats(
            ref, center=center, radius=args.against_radius,
            noise_threshold=args.noise_threshold)
        sim_stats = cartesian_stats(cart,
                                    noise_threshold=args.noise_threshold)
        report["reference_stats"] = ref_stats
        report["sim_cartesian_stats"] = sim_stats
        report["comparison"] = compare_imaging_stats(sim_stats, ref_stats)
        for k, v in report["comparison"].items():
            print(f"{k}: {v:.4f}")
    if args.stats_out:
        Path(args.stats_out).write_text(json.dumps(report, indent=2))
        print(f"wrote {args.stats_out}")
    return 0


def cmd_prime_cache(args) -> int:
    """Build + persist a mesh's host build so later runs start warm: a
    cached start is one np.load (geom/cache.py). --force removes the entry
    and builds it anew. Prints the builder (native or numpy) and the
    seconds of each stage: the ordering, the planes and chunk AABBs, the
    device tables (coef and fetch, which every upload makes again from the
    entry) and the store."""
    from radarays_ros_tpu_torch.geom import cache as scache
    from radarays_ros_tpu_torch.geom.scene import device_tables

    scene = _load_scene(args)
    key = scache.scene_cache_key(scene.verts, scene.obj_ids,
                                 scene.chunk_size)
    path = scache.default_cache_dir() / f"{key}.npz"
    if path.exists():
        if not args.force:
            print(f"already primed: {path} "
                  f"({path.stat().st_size / 1e9:.2f} GB)")
            return 0
        path.unlink()
    stages = {}
    t0 = time.perf_counter()
    host = scene.host_arrays(cache=True, stages=stages)
    dt = time.perf_counter() - t0
    if not path.exists():
        print(f"built tables in {dt:.1f}s but the cache entry was not "
              f"written (disk full / read-only cache dir?)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    device_tables(host)
    stages["tables_s"] = time.perf_counter() - t0
    print(f"primed {scene.n_triangles} triangles "
          f"({host.chunk_lo.shape[0]} chunks) in {dt:.1f}s -> {path} "
          f"({path.stat().st_size / 1e9:.2f} GB)")
    print(f"builder {stages['builder']} ({stages['variant']}): ordering "
          f"{stages['order_s']:.3f} s, planes and AABBs "
          f"{stages['planes_s']:.3f} s, coef and fetch tables "
          f"{stages['tables_s']:.3f} s, store {stages['store_s']:.3f} s")
    return 0


_ENGINES = ["auto", "brute", "sweep", "kernel", "mxu", "culled", "pallas3"]
_ENGINE_HELP = ("trace engine override: auto (kernel on CUDA, sweep on CPU),"
                " brute, sweep, kernel, mxu; the reference's culled = sweep "
                "and pallas3 = kernel")


def _device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing CUDA"
                        " device is an error, not a fallback")


def _common(p: argparse.ArgumentParser):
    p.add_argument("--mesh", required=True,
                   help="scene mesh (.ply/.obj/.stl/.dae)")
    p.add_argument("--scene-config", help="materials YAML (reference format)")
    p.add_argument("--preset", help="dyncfg preset YAML")
    p.add_argument("--engine", choices=_ENGINES, help=_ENGINE_HELP)
    p.add_argument("--chunk-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--traj", help="TUM trajectory file")
    _device_arg(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="radarays_ros_tpu_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)

    sim = sub.add_parser("simulate", help="render radar frames")
    _common(sim)
    sim.add_argument("--frames", type=int, default=1)
    sim.add_argument("--batch", type=int, default=1,
                     help="render frames in batches of this size through "
                          "simulate_frames_jit (throughput mode; "
                          "incompatible with include_motion)")
    sim.add_argument("--rate", type=float, default=4.0,
                     help="free-running frame rate [Hz] (stamp spacing)")
    sim.add_argument("--synced", action="store_true",
                     help="replay the trajectory's own stamps (sync mode)")
    sim.add_argument("--scan-duration", type=float, default=0.25,
                     help="scan period for include_motion pose interpolation")
    sim.add_argument("--out", default="out")
    sim.add_argument("--format", choices=["png", "npy"], default="png")
    sim.set_defaults(fn=cmd_simulate)

    rays = sub.add_parser("rays", help="debug-trace one beam")
    _common(rays)
    rays.add_argument("--yaw", type=float, default=0.0)
    rays.add_argument("--bounces", type=int, default=3)
    rays.add_argument("--cone", action="store_true",
                      help="trace a sampled cone instead of a single ray")
    rays.add_argument("--all-directions", action="store_true",
                      help="360-degree fan (shoot_all_directions)")
    rays.add_argument("--n-fan", type=int, default=360)
    rays.add_argument("--spin", type=int, default=1,
                      help="number of spinning shots (RayReflection.cfg)")
    rays.add_argument("--yaw-increment", type=float, default=0.0175,
                      help="yaw step between spinning shots [rad]")
    rays.add_argument("--stamp", type=float, default=0.0)
    rays.add_argument("--compact", action="store_true")
    rays.add_argument("--out")
    rays.set_defaults(fn=cmd_rays)

    info = sub.add_parser("info", help="mesh/scene statistics")
    _common(info)
    info.set_defaults(fn=cmd_info)

    pc = sub.add_parser(
        "prime-cache",
        help="build + persist a mesh's host build (warm-start cache)")
    pc.add_argument("--mesh", required=True,
                    help="scene mesh (.ply/.obj/.stl/.dae)")
    pc.add_argument("--chunk-size", type=int, default=256)
    pc.add_argument("--force", action="store_true",
                    help="rebuild even if the entry already exists")
    pc.set_defaults(fn=cmd_prime_cache)

    opt = sub.add_parser("optimize",
                         help="fit material properties to a target frame")
    _common(opt)
    opt.add_argument("--target", required=True,
                     help="target polar frame (.png/.npy), e.g. a real scan")
    opt.add_argument("--slots", default="1",
                     help="comma list of material slots to tune (ref: 1,3)")
    opt.add_argument("--steps", type=int, default=60)
    opt.add_argument("--lr", type=float, default=5e-2)
    opt.add_argument("--method", choices=["gradient", "black-box"],
                     default="gradient")
    opt.add_argument("--pose", default=None,
                     help="sensor pose 'tx,ty,tz' (default origin)")
    opt.add_argument("--checkpoint", help="write/resume optimizer state here")
    opt.add_argument("--out-config",
                     help="write the fitted materials as a scene YAML")
    opt.set_defaults(fn=cmd_optimize)

    ev = sub.add_parser(
        "eval", help="compare real frames against sim (dir-vs-dir, or "
                     "stamp-synced against a live simulation)")
    ev.add_argument("--real", required=True,
                    help="directory of real frames (.png/.npy; stamps from "
                         "stamps.txt, numeric filenames, or --stamps)")
    ev.add_argument("--sim", help="directory of sim frames (dir-vs-dir mode)")
    ev.add_argument("--mesh", help="scene mesh for stamp-synced mode")
    ev.add_argument("--scene-config", help="materials YAML")
    ev.add_argument("--preset", help="dyncfg preset YAML")
    ev.add_argument("--engine", choices=_ENGINES, help=_ENGINE_HELP)
    ev.add_argument("--chunk-size", type=int, default=256)
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--traj", help="TUM trajectory for stamp-synced mode")
    ev.add_argument("--stamps", help="explicit stamps file for --real")
    ev.add_argument("--real-transpose", action="store_true",
                    help="real frames are stored (azimuth, range)")
    ev.add_argument("--metrics", default="psnr,ssim",
                    help="comma list: psnr,ssim,mi,nmi,voi,mae")
    ev.add_argument("--limit", type=int)
    ev.add_argument("--out", help="write the full JSON report here")
    _device_arg(ev)
    ev.set_defaults(fn=cmd_eval)

    ex = sub.add_parser(
        "explore", help="2-D physics explorer panels (the reference's "
                        "scripts/reflections + beams + BRDF tools)")
    ex.add_argument("--panel", required=True,
                    choices=["brdf", "fresnel", "slab", "beams"])
    ex.add_argument("--json", help="write the panel data as JSON here")
    ex.add_argument("--plot", help="write a rendered figure (PNG) here")
    ex.add_argument("--interactive", action="store_true",
                    help="open a live slider explorer (brdf/fresnel/beams; "
                         "needs a GUI matplotlib backend)")
    # brdf: the back-reflection polynomial's material triple
    ex.add_argument("--ambient", type=float, default=1.0)
    ex.add_argument("--diffuse", type=float, default=0.2)
    ex.add_argument("--specular", type=float, default=30.0)
    # fresnel: wave velocity pair + polarization
    ex.add_argument("--v1", type=float, default=0.3)
    ex.add_argument("--v2", type=float, default=0.15)
    ex.add_argument("--polarization", type=float, default=0.5)
    # slab: media stack + start ray
    ex.add_argument("--depths", default="0.0,-0.2",
                    help="comma list of interface depths (decreasing)")
    ex.add_argument("--velocities", default="0.3,0.15,0.3",
                    help="comma list of len(depths)+1 media velocities")
    ex.add_argument("--origin", default="0.0,1.0")
    ex.add_argument("--direction", default="0.6,-0.8")
    ex.add_argument("--bounces", type=int, default=4)
    # beams: cone sampling
    ex.add_argument("--beam-width", type=float, default=8.0)
    ex.add_argument("--n-samples", type=int, default=2000)
    ex.add_argument("--p-in-cone", type=float, default=0.8)
    ex.add_argument("--seed", type=int, default=0)
    _device_arg(ex)
    ex.set_defaults(fn=cmd_explore)

    rd = sub.add_parser(
        "render", help="paper-style cartesian view of a polar frame "
                       "(+ stats comparison against a reference image)")
    rd.add_argument("--frame", required=True,
                    help="polar frame (.png mono8 or .npy, (n_cells, A))")
    rd.add_argument("--out", help="cartesian PNG output")
    rd.add_argument("--color", action="store_true",
                    help="papercolor colormap instead of grayscale")
    rd.add_argument("--stretch", action="store_true",
                    help="percentile contrast stretch for display")
    rd.add_argument("--size", type=int, default=800)
    rd.add_argument("--scroll", type=int, default=0)
    rd.add_argument("--resolution", type=float, default=0.0595238,
                    help="m/cell (for --max-range)")
    rd.add_argument("--max-range", type=float,
                    help="crop the view at this range [m]")
    rd.add_argument("--noise-threshold", type=int, default=32)
    rd.add_argument("--against-polar",
                    help="reference POLAR image/panel to compare polar "
                         "statistics against (rows=range, cols=azimuth)")
    rd.add_argument("--against-crop",
                    help="'x0,y0,x1,y1' pixel crop of --against-polar")
    rd.add_argument("--against-image",
                    help="reference cartesian image to compare statistics "
                         "against (e.g. the published figure)")
    rd.add_argument("--against-center",
                    help="'cx,cy' pixel center of the reference view "
                         "(default: image center)")
    rd.add_argument("--against-radius", type=float,
                    help="radius [px] of the reference radar disc")
    rd.add_argument("--stats-out", help="write the stats report JSON here")
    rd.set_defaults(fn=cmd_render)
    return ap


def main(argv=None) -> int:
    # surface the stage logs (mesh load, scene build and cache): a cold
    # host build of a large scene is seconds of work that would pass in
    # silence
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def main_simulator() -> int:
    """Console entry `radar-simulator-torch` (the reference's node name)."""
    return main(["simulate"] + sys.argv[1:])


def main_ray_reflection() -> int:
    """Console entry `ray-reflection-test-torch` (the reference's debug
    node)."""
    return main(["rays"] + sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
