"""Frame layouts over several ranks (the twin of the JAX repo's
benchmarks/bench_multichip.py), over parallel/launch.py:run_ranks.

    python -m radarays_ros_tpu_torch.bench.multichip [--ranks N]
        [--buildings 800] [--smp 2] [--iters 5]
    python -m radarays_ros_tpu_torch.bench.multichip --cpu-ranks N

Times two layouts of one KAIST-class frame (400 azimuths, 48 samples, 4
reflections) over the ranks of one torch.distributed group:

  * "az": the azimuth rows split over every rank (parallel/sharding.py:
    simulate_frame_sharded);
  * "az_smp": azimuth x beam samples, --smp ranks on the sample axis
    (simulate_frame_sharded_2d), when the ranks and the samples divide
    over it — the reference also asks for two azimuth ranks; one is kept
    here, so that two ranks already split one frame's samples.

Every timed iteration ends in rank 0's fetch of the frame's checksum, with
fresh random inputs (cone draws, Perlin offsets from default_rng(i)),
after one warm-up frame; best and median Hz. --ranks defaults to the
card count; ranks beyond the cards share them over gloo (NCCL refuses two
ranks on one card), and every line then says "ranks_share_one_card": true
— time-sliced contexts on one card, not a scaling figure. --cpu-ranks N
is the reference's --cpu-mesh N smoke mode: N gloo ranks on the CPU over
its small scene (24 buildings over 60 m, chunk size 16, 256 cells).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C


def setup(small: bool, n_buildings: int):
    """bench_multichip.py:58-79: (host build, params as numpy, cfg,
    poses (n_angles, 7))."""
    from radarays_ros_tpu_torch.parallel.dryrun import params_numpy
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import identity_pose

    scene = C.urban_scene(24 if small else n_buildings,
                          60.0 if small else 300.0, 7,
                          16 if small else 256)
    params = RadarParams.make(Materials.from_list([C.AIR, C.WALL]),
                              np.ones(scene.n_objects, np.int32),
                              beam_width_deg=10.0)
    cfg = RadarModelConfig(
        n_angles=400, n_cells=256 if small else 3424, resolution=0.0595238,
        n_samples=48, n_reflections=4, beam_sample_dist=2, energy_max=0.72,
        signal_max=110.0, signal_denoising=1,
        signal_denoising_triangular_width=35,
        signal_denoising_triangular_mode=0.35, ambient_noise=2,
        record_multi_reflection=True, opaque_materials=True,
        trace_engine="kernel", trace_ray_block=2048, trace_aux_baked=True)
    poses = np.tile(identity_pose(), (cfg.n_angles, 1))
    poses[:, 2] = 2.0
    return scene.host_arrays(cache=False), params_numpy(params), cfg, poses


def inputs(cfg, seed: int) -> dict:
    """One frame's random inputs, the same in every rank."""
    rng = np.random.default_rng(seed)
    S = cfg.n_samples
    return dict(cone_draws=(rng.uniform(-np.pi, np.pi, S).astype(np.float32),
                            rng.standard_normal(S).astype(np.float32)),
                random_begin=rng.integers(0, 1000, cfg.n_angles))


def layout_rank(rank: int, world: int, device, su, layouts, iters: int,
                seed: int) -> dict:
    """run_ranks worker: each layout's warm-up frame (returned as numpy by
    rank 0), then `iters` timed frames, each ended by the fetch of its
    checksum; rank 0's seconds, checksums and kernel launches."""
    import torch.distributed as dist

    from radarays_ros_tpu_torch.geom.scene import scene_tensors
    from radarays_ros_tpu_torch.parallel.dryrun import LAYOUTS, baked
    from radarays_ros_tpu_torch.sim.config import params_from_numpy

    host, params_np, cfg, poses = su
    params = params_from_numpy(*params_np, device=device)
    st = baked(scene_tensors(host, device), params, cfg)
    out = {}
    for name in layouts:
        fn, make, _ = LAYOUTS[name]
        mesh = make()

        def frame(i):
            return fn(st, params, cfg, poses, mesh, device=device,
                      **inputs(cfg, seed + i))

        warm = frame(0)
        dist.barrier()
        C.zero_launches()
        times, sums = [], []
        for i in range(1, iters + 1):
            C.fence(device)
            t0 = time.perf_counter()
            sums.append(int(C.frame_checksum(frame(i))))
            times.append(time.perf_counter() - t0)
        out[name] = dict(frame=tuple(x.detach().cpu().numpy() for x in warm),
                         seconds=times, checksums=sums,
                         kernel_launches=C.read_launches())
    return out


def main(argv=None) -> dict:
    """Returns rank 0's results (the warm-up frames included)."""
    from radarays_ros_tpu_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    C.add_device_arg(ap)
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks on the card(s); default the card count")
    ap.add_argument("--buildings", type=int, default=800)
    ap.add_argument("--smp", type=int, default=2,
                    help="sample-axis size of the 2-D layout")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu-ranks", type=int, default=0,
                    help="N gloo ranks on the CPU (smoke mode)")
    args = ap.parse_args(argv)
    small = args.cpu_ranks > 0
    dev = C.resolve_device("cpu" if small else args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    ranks = args.cpu_ranks or args.ranks or max(cards, 1)
    backend = "nccl" if dev.type == "cuda" and ranks <= cards else "gloo"
    shared = dev.type == "cuda" and ranks > cards
    su = setup(small, args.buildings)
    cfg = su[2]
    layouts = ["az"]
    if ranks % args.smp == 0 and cfg.n_samples % args.smp == 0:
        layouts.append("az_smp")
    C.emit({"ranks": ranks, "backend": backend,
            "device": C.card_identity(dev), "ranks_share_one_card": shared,
            "n_triangles": int(su[0].verts.shape[0])})
    out = run_ranks(layout_rank, ranks, backend=backend, device=dev.type,
                    args=(su, layouts, args.iters, 0))
    for name in layouts:
        r = out[name]
        best = min(r["seconds"])
        med = float(np.median(r["seconds"]))
        C.emit({"bench": {"az": "frame_sharded_1d_az",
                          "az_smp": "frame_sharded_2d_az_smp"}[name],
                "ranks": ranks, **({"mesh": [ranks // args.smp, args.smp]}
                                   if name == "az_smp" else {}),
                "best_hz": 1.0 / best, "med_hz": 1.0 / med,
                "device": C.card_identity(dev),
                "ranks_share_one_card": shared,
                "kernel_launches_rank0": r["kernel_launches"]})
    return out


if __name__ == "__main__":
    main()
