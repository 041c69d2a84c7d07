"""Headline benchmark of the port (the twin of the JAX repo's bench.py):
full rotating-radar frames/s on the card.

Workload: the MulRan KAIST02 preset (400 azimuths x 3424 range cells, 50
samples a beam, 4 reflections, triangular denoise 35/0.35, Perlin noise)
at three scene scales: ~1M triangles (the headline), ~10k and ~10M (the
companions), in batches of 20 frames.

    python -m radarays_ros_tpu_torch.bench.headline [--device cpu]
        [--seed 0] [--details build/bench_torch_details.json]

Stages, as bench.py: the exactness gate (`parity_check`: engine "kernel"
against the exact plain sweep), then the 1M measurement, whose ONE stdout
JSON line is printed right after it; then the companions, within the wall
budget RADARAYS_BENCH_BUDGET_S (default 2400 s), logged to stderr and
written with the headline to --details.

Protocols (`measure_scale`, bench.py:185-255): fenced — every timed batch
ends in the fetch of its checksum (the sum of its u8 pixels), giving the
best and the trimmed median; sustained — 10 batches queued back to back,
every checksum fetched at the end. Each batch draws fresh random inputs
(cone, Perlin offsets) from one torch.Generator seeded from --seed. The
reference varies its inputs because its relay dedups identical calls; on
the card the checksums guard against counting a batch that never ran (a
queued launch that failed, or work skipped), since the clock stops only
once every batch's result is on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C

METRIC = "radar_frames_per_sec_400x3424_kaist_preset_1M_tris"
HEADLINE = dict(n_buildings=83000)                      # bench.py:287
COMPANIONS = (("small_10k", dict(n_buildings=800)),     # bench.py:320-322
              ("huge_10m", dict(n_buildings=830000, extent=950.0)))


def parity_check(n_buildings: int = 16600, n_rays: int = 131072,
                 chunk_size: int = 256, *, device, **trace_kwargs) -> dict:
    """The exactness gate (bench.py:59-115): engine "kernel" against the
    exact plain sweep ("sweep") on make_urban_scene(n_buildings, 140,
    seed=11) and the 400-azimuth fan of n_rays rays; exact means no hit
    and no object mismatch and equal distances on the common hits."""
    from radarays_ros_tpu_torch.trace.api import trace

    dev = torch.device(device)
    o, d = C.on(dev, *C.radar_fan(n_rays))
    st = C.urban_scene(n_buildings, 140.0, 11, chunk_size).to_device(dev)
    rp = trace(st, o, d, engine="kernel", ray_block=2048, **trace_kwargs)
    rc = trace(st, o, d, engine="sweep", ray_block=2048)
    common = rp.hit & rc.hit
    hit_mm = int((rp.hit != rc.hit).sum())
    obj_mm = int((rp.obj_id[common] != rc.obj_id[common]).sum())
    max_dt = (float((rp.t[common] - rc.t[common]).abs().max())
              if bool(common.any()) else 0.0)
    return {
        "n_triangles": st.n_triangles,
        "n_rays": int(o.shape[0]),
        "hit_rate": round(int(rp.hit.sum()) / rp.hit.numel(), 4),
        "hit_mismatches": hit_mm,
        "obj_mismatches_on_common_hits": obj_mm,
        "max_abs_dt_on_common_hits": max_dt,
        "exact": bool(hit_mm == 0 and obj_mm == 0 and max_dt == 0.0),
    }


def measure_scale(n_buildings: int, n_iters: int = 7, batch: int = 20,
                  extent: float = 300.0, n_stream: int = 10,
                  cfg_overrides: Optional[dict] = None,
                  chunk_size: int = 256, scene=None, *, device,
                  seed: int = 0) -> dict:
    """Frame throughput at one scene scale under the two protocols (module
    doc), after one warm-up batch. scene: a common.Benchmark built
    already (then n_buildings, extent, cfg_overrides and chunk_size are
    not used). Returns sustained_hz, best_hz, trimmed_median_hz,
    n_triangles, rays_per_frame, trace_engine, batch, the kernels'
    launches over the timed batches, the timed batch count and every
    checksum."""
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frames
    from radarays_ros_tpu_torch.trace.api import resolve_engine
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    dev = torch.device(device)
    b = scene or C.build_benchmark(n_buildings, extent,
                                   cfg_overrides=cfg_overrides,
                                   chunk_size=chunk_size, device=dev)
    poses = torch.from_numpy(np.tile(make_pose([0.0, 0.0, 2.0]),
                                     (batch, 1)))
    gen = torch.Generator(dev).manual_seed(seed)

    def run(_i):
        return C.frame_checksum(simulate_frames(b.scene, b.params, b.cfg,
                                                poses, generator=gen))

    t0 = time.perf_counter()
    int(run(0))
    C.log(f"bench: warm-up batch {time.perf_counter() - t0:.1f}s")
    C.zero_launches()
    times, fenced = C.fenced_times(run, n_iters, dev)
    stream_s, streamed = C.sustained_s(run, n_stream, dev)
    launches = C.read_launches()
    sums = fenced + streamed
    if min(sums) == 0:
        C.log("bench: WARNING an all-zero batch (unexpected for this scene)")
    best, tmed = C.best_and_trimmed(times)
    cfg = b.cfg
    return dict(
        sustained_hz=batch * n_stream / stream_s, best_hz=batch / best,
        trimmed_median_hz=batch / tmed, n_triangles=b.scene.n_triangles,
        rays_per_frame=cfg.n_angles * cfg.n_samples * cfg.n_reflections,
        trace_engine=resolve_engine(cfg.trace_engine, dev), batch=batch,
        kernel_launches=launches, timed_batches=n_iters + n_stream,
        checksums=sums)


def _pack(m: dict) -> dict:
    return {"sustained_hz": round(m["sustained_hz"], 3),
            "best_hz": round(m["best_hz"], 3),
            "trimmed_median_hz": round(m["trimmed_median_hz"], 3),
            "n_triangles": m["n_triangles"],
            "kernel_launches": m["kernel_launches"],
            "timed_batches": m["timed_batches"]}


def main(argv=None, *, headline: Optional[dict] = None,
         companions=COMPANIONS, cfg_overrides: Optional[dict] = None,
         parity_kw: Optional[dict] = None) -> dict:
    """Run the gate, the headline scale and the companions; print the one
    headline line and write --details. headline, companions,
    cfg_overrides and parity_kw cut the run to size (tests); the command
    line runs bench.py's scales. Returns the details."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    C.add_device_arg(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--details", default=str(C.BUILD
                                             / "bench_torch_details.json"))
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    smi = C.card_identity(dev)
    wall0 = time.perf_counter()

    # the exactness gate first: its verdict rides inside the headline line
    par = parity_check(device=dev, **(parity_kw or {}))
    C.log(f"bench: parity {json.dumps(par)}")

    m = measure_scale(**(headline or HEADLINE), cfg_overrides=cfg_overrides,
                      device=dev, seed=args.seed)
    line = {
        "metric": METRIC,
        "value": round(m["sustained_hz"], 3),
        "unit": "Hz",
        "parity": par,
        "extra": {
            "protocol": "sustained streaming throughput: 10 batches of 20 "
                        "frames queued back to back (fresh random inputs), "
                        "every checksum fetched at the end; fenced "
                        "per-batch numbers alongside. Companion scales "
                        "(10k/10M tris) run after this line prints: see "
                        "the details file.",
            "fenced_best_hz": round(m["best_hz"], 3),
            "fenced_trimmed_median_hz": round(m["trimmed_median_hz"], 3),
            "n_triangles": m["n_triangles"],
            "mrays_per_sec": round(m["sustained_hz"] * m["rays_per_frame"]
                                   / 1e6, 2),
            "rays_per_frame": m["rays_per_frame"],
            "device": smi,
            "trace_engine": m["trace_engine"],
            "batch": m["batch"],
            "kernel_launches": m["kernel_launches"],
            "timed_batches": m["timed_batches"],
        },
    }
    C.emit(line)      # THE one stdout line, before the companions run

    details = {"headline": line}
    budget_s = float(os.environ.get("RADARAYS_BENCH_BUDGET_S", "2400"))
    for name, kwargs in companions:
        elapsed = time.perf_counter() - wall0
        if elapsed > budget_s:
            details[name] = {"skipped": f"wall budget ({elapsed:.0f}s "
                                        f"> {budget_s:.0f}s)"}
            C.log(f"bench: skipping {name}: over wall budget")
            continue
        details[name] = _pack(measure_scale(**kwargs,
                                            cfg_overrides=cfg_overrides,
                                            device=dev, seed=args.seed))
        C.log(f"bench: {name}: {json.dumps(details[name])}")
    out = Path(args.details)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(details, indent=2) + "\n")
    C.log(f"bench: details written to {out}")
    return details


if __name__ == "__main__":
    main()
