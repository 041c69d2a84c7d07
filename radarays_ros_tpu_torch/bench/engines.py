"""Trace-engine and frame microbenchmarks of the port (the twin of the JAX
repo's benchmarks/engines.py).

    python -m radarays_ros_tpu_torch.bench.engines [--device cpu]
        [--buildings 800] [--rays 160000] [--frames 10]
        [--engines brute,sweep,kernel,mxu,auto]
    python -m radarays_ros_tpu_torch.bench.engines --saturated
        [--buildings 83000]

Times each trace engine on a raw ray batch (the coherent 400-azimuth fan,
elevations ~ N(0, 0.03)), the median of 5 fetch-forced traces, then the
KAIST-preset frame per engine. `--saturated` runs only the saturated
engine-"kernel" suite at 1,048,576 rays a set over the ~1M-triangle scene:
the coherent fan, incoherent rays (random directions from random origins
in the middle 80 % of the scene's box), the same sorted (`sort_rays`),
and sorted with the two-phase requeue at 75 m — Mrays/s (median of 3),
hit rate and peak device memory over the resident scene.

One JSON line per measurement; the last line of the engine run is a
summary. Each timed trace ends in the fetch of a checksum of its result;
the inputs move by a relative 1e-6 per call, as the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C

SAT_RAYS = 1_048_576
SAT_CAP = 75.0          # the two-phase requeue's cap [m] (engines.py:128)
# (name, ray set, trace keywords)
SAT_SETS = (("coherent", "coherent", {}),
            ("incoherent", "incoherent", {}),
            ("incoherent_sorted", "incoherent", dict(sort_rays=True)),
            ("incoherent_sorted_two_phase", "incoherent",
             dict(sort_rays=True, two_phase_cap=SAT_CAP)))


def median_time(fn, n: int = 5) -> float:
    """The median seconds of fn(i), which must fetch a result."""
    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def incoherent_rays(scene, n_rays: int, seed: int = 0):
    """engines.py:59-68: random directions from random origins in the
    middle 80 % of the bounding box of the scene's real chunks (the far
    padding chunks excluded). Returns numpy (o, d)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lo_c = scene.chunk_lo.cpu().numpy()
    hi_c = scene.chunk_hi.cpu().numpy()
    real = hi_c[:, 0] < 1e7
    lo, hi = lo_c[real].min(0), hi_c[real].max(0)
    o = lo + rng.uniform(0.1, 0.9, size=(n_rays, 3)) * (hi - lo)
    return o.astype(np.float32), d.astype(np.float32)


def _engine_scene(st, engine: str):
    from radarays_ros_tpu_torch.geom.scene import with_planes

    return with_planes(st) if engine == "mxu" else st


def trace_engines(st, o, d, engines, dev, n: int = 5) -> dict:
    """Each engine on the rays o, d (device tensors): its result, hit rate
    and median seconds of n fetch-forced traces (ray block 2048)."""
    from radarays_ros_tpu_torch.trace.api import trace

    out = {}
    for engine in engines:
        sc = _engine_scene(st, engine)
        kw = {} if engine == "brute" else {"ray_block": 2048}
        res = trace(sc, o, d, engine=engine, **kw)
        dt = median_time(lambda i: int(trace(
            sc, o, d * (1.0 + 1e-6 * (i + 1)), engine=engine,
            **kw).hit.sum()), n)
        out[engine] = dict(result=res, seconds=dt,
                           hit_rate=float(res.hit.float().mean()))
    return out


def saturated(st, dev, n_rays: int = SAT_RAYS, seed: int = 0) -> list:
    """The saturated suite (module doc): one record a set."""
    from radarays_ros_tpu_torch.trace.api import trace

    fan = C.on(dev, *C.radar_fan(n_rays, seed))
    sets = {"coherent": fan,
            "incoherent": C.on(dev, *incoherent_rays(st, n_rays, seed))}
    out = []
    for name, rays, kw in SAT_SETS:
        o, d = sets[rays]

        def run(dd):
            r = trace(st, o, dd, engine="kernel", ray_block=2048, **kw)
            return (torch.where(torch.isfinite(r.t), r.t, 0.0).sum(),
                    r.hit.float().mean())

        C.fence(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        resident = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                    else None)
        hit_rate = float(run(d)[1])
        C.zero_launches()
        dt = median_time(lambda i: float(run(d * (1.0 + 1e-6 * (i + 1)))[0]),
                         n=3)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        out.append(C.emit({
            "bench": "saturated_trace", "engine": "kernel", "set": name,
            "rays": n_rays, **({"two_phase_cap": kw["two_phase_cap"]}
                               if "two_phase_cap" in kw else {}),
            "mrays_per_sec": n_rays / dt / 1e6, "ms": dt * 1e3,
            "hit_rate": hit_rate,
            "peak_mib": None if peak is None else peak / 2**20,
            "peak_over_resident_mib": None if peak is None
            else (peak - resident) / 2**20,
            "kernel_launches": C.read_launches()}))
    return out


def frames(st, params, engines, dev, n: int) -> dict:
    """The KAIST frame per engine (engines.py:160-198: the preset without
    the noise-shape fields of bench.py), median of n fetch-forced frames
    after one warm-up: Hz and ms."""
    from radarays_ros_tpu_torch.sim.config import RadarModelConfig
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    pose = torch.from_numpy(make_pose([0.0, 0.0, 2.0]))
    out = {}
    for engine in engines:
        cfg = RadarModelConfig(
            n_angles=400, n_cells=3424, resolution=0.0595238, n_samples=50,
            n_reflections=4, beam_sample_dist=2, energy_max=0.72,
            signal_max=110.0, signal_denoising=1,
            signal_denoising_triangular_width=35,
            signal_denoising_triangular_mode=0.35, ambient_noise=2,
            record_multi_reflection=True, trace_engine=engine,
            trace_ray_block=2048)
        sc = _engine_scene(st, engine)
        gen = torch.Generator(dev).manual_seed(0)

        def one(_i):
            return int(C.frame_checksum(simulate_frame(
                sc, params, cfg, pose, generator=gen)))

        one(0)
        C.zero_launches()
        dt = median_time(one, n)
        out[engine] = 1.0 / dt
        C.emit({"bench": "frame", "engine": engine, "hz": 1.0 / dt,
                "ms": dt * 1e3, "kernel_launches": C.read_launches()})
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    C.add_device_arg(ap)
    ap.add_argument("--buildings", type=int, default=None,
                    help="default 800, or 83000 with --saturated")
    ap.add_argument("--rays", type=int, default=160_000)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--engines", default="brute,sweep,kernel,mxu,auto")
    ap.add_argument("--saturated", action="store_true")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    n_b = args.buildings or (83000 if args.saturated else 800)
    b = C.build_benchmark(n_b, chunk_size=args.chunk_size, device=dev)
    st = b.scene
    C.emit({"device": C.card_identity(dev), "n_triangles": st.n_triangles,
            "n_chunks": st.n_chunks})
    if args.saturated:
        return saturated(st, dev)

    engines = args.engines.split(",")
    o, d = C.on(dev, *C.radar_fan(args.rays, el_std=0.03))
    traced = {}
    for engine in engines:
        C.zero_launches()
        r = trace_engines(st, o, d, [engine], dev)[engine]
        traced[engine] = args.rays / r["seconds"] / 1e6
        C.emit({"bench": "trace", "engine": engine,
                "mrays_per_sec": traced[engine], "ms": r["seconds"] * 1e3,
                "hit_rate": r["hit_rate"],
                "kernel_launches": C.read_launches()})
    hz = frames(st, b.params, engines, dev, args.frames)
    return [C.emit({"summary": {"trace_mrays": traced, "frame_hz": hz}})]


if __name__ == "__main__":
    main()
