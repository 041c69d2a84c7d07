"""A/B of the chunk orderings, the median split against the SAH-scored
split (the twin of the JAX repo's benchmarks/order_ab.py).

    python -m radarays_ros_tpu_torch.bench.order_ab --proxy [--device cpu]
        [--buildings 83000] [--rays 8192] [--variants median,sah]
    python -m radarays_ros_tpu_torch.bench.order_ab --hw
        [--skip-parity] [--skip-marginal] [--skip-frame]

K1's cost is (visited chunks) x chunk size lanes a ray block, so the
quality of the chunk boxes multiplies throughput. Two stages:

  1. --proxy (host only): build the bench scene under each ordering with
     the port's NumPy host build and count, for the coherent fan, the chunk
     boxes each ray's slab test keeps within --t-max: the proxy of the
     prep's kept set and the sweep's visits, with no device time. The
     counts are the reference proxy's (`overlap_stats`, the same NumPy).
  2. --hw: the parity gate, the chained-marginal trace and the frame
     (sweep_kernel_ab's stages) under RADARAYS_ORDER_VARIANT=<variant>,
     each variant in a process of its own; their lines come back with
     the variant added.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from radarays_ros_tpu_torch.bench import common as C
from radarays_ros_tpu_torch.bench import sweep_kernel_ab as SK


def overlap_stats(lo: np.ndarray, hi: np.ndarray, o: np.ndarray,
                  d: np.ndarray, t_max: float) -> dict:
    """Per-ray count of chunk boxes the slab test keeps within t_max (the
    reference's order_ab.py:overlap_stats, the same NumPy)."""
    idv = np.where(d != 0.0, 1.0 / d, np.inf).astype(np.float32)
    n_rays = o.shape[0]
    counts = np.zeros(n_rays, np.int64)
    B = 512
    for i in range(0, n_rays, B):
        ob, ib = o[i:i + B], idv[i:i + B]
        t0 = (lo[None, :, :] - ob[:, None, :]) * ib[:, None, :]
        t1 = (hi[None, :, :] - ob[:, None, :]) * ib[:, None, :]
        tn = np.minimum(t0, t1).max(axis=2)
        tf = np.maximum(t0, t1).min(axis=2)
        tn0 = np.maximum(tn, 0.0)
        keep = (tf >= tn0) & (tn <= t_max)
        counts[i:i + B] = keep.sum(axis=1)
    return {
        "mean_overlaps_per_ray": round(float(counts.mean()), 2),
        "p90_overlaps": int(np.percentile(counts, 90)),
        "max_overlaps": int(counts.max()),
        "total_overlaps": int(counts.sum()),
    }


def chunk_sa_sum(lo: np.ndarray, hi: np.ndarray) -> float:
    d = hi - lo
    return float((d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                  + d[:, 2] * d[:, 0]).sum())


def host_build(n_buildings: int, chunk_size: int = 256,
               variant: str = "sah"):
    """The bench scene's NumPy host build (geom/scene.py, no cache) under
    the ordering `variant`: the reference proxy's build, bit for bit (the
    C++ library's median split breaks centroid ties otherwise). Returns
    (SceneHost, seconds)."""
    scene = C.urban_scene(n_buildings, 300.0, 7, chunk_size)
    with C.environ(RADARAYS_ORDER_VARIANT=variant, RADARAYS_NO_NATIVE="1"):
        t0 = time.perf_counter()
        h = scene.host_arrays(cache=False)
        return h, time.perf_counter() - t0


def proxy_record(h, o, d, t_max: float, build_s: float) -> dict:
    lo, hi = h.chunk_lo, h.chunk_hi
    return {"n_chunks": int(lo.shape[0]), "build_s": round(build_s, 1),
            "chunk_sa_sum": round(chunk_sa_sum(lo, hi), 1),
            **overlap_stats(lo, hi, o, d, t_max)}


def add_proxy_args(ap) -> None:
    ap.add_argument("--proxy", action="store_true")
    ap.add_argument("--hw", action="store_true")
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--t-max", type=float, default=203.8)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    SK.add_stage_args(ap)
    add_proxy_args(ap)
    ap.add_argument("--variants", default="median,sah")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    variants = args.variants.split(",")
    out = []
    if args.proxy:
        o, d = C.radar_fan(args.rays)
        for variant in variants:
            h, dt = host_build(args.buildings, variant=variant)
            out.append(C.emit({"stage": "proxy", "variant": variant,
                               **proxy_record(h, o, d, args.t_max, dt)}))
    if args.hw:
        for variant in variants:
            cmd = [sys.executable, "-m",
                   "radarays_ros_tpu_torch.bench.sweep_kernel_ab",
                   "--device", args.device, "--buildings",
                   str(args.buildings)] + [f"--skip-{s}"
                                           for s in SK.skipped(args)]
            run = subprocess.run(
                cmd, stdout=subprocess.PIPE, text=True, check=True,
                env=C.child_env(RADARAYS_ORDER_VARIANT=variant))
            for line in run.stdout.splitlines():
                if line.startswith("{"):
                    out.append(C.emit({**json.loads(line),
                                       "variant": variant}))
    return out


if __name__ == "__main__":
    main()
