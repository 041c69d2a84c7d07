"""Validate and time the sweep kernel K1 and its prep on the card (the twin
of the JAX repo's benchmarks/sweep_kernel_ab.py).

    python -m radarays_ros_tpu_torch.bench.sweep_kernel_ab [--device cpu]
        [--buildings 83000] [--skip-parity] [--skip-marginal] [--skip-frame]

Three stages, one JSON line each (after an "env" line):
  1. parity: engine "kernel" against the exact plain sweep on the ~200k-
     triangle scene and the 131,072-ray fan (headline.parity_check);
  2. trace_marginal: the chained-marginal trace at the ~1M-triangle scale,
     409,600 fan rays: a chain of k traces, each fed by the previous one's
     result (its origins are o + 0 x the previous checksum), timed by CUDA
     events around the chain and its fetched checksum, the median of 5;
     the marginal trace is (t_k - t_1) / (k - 1), which takes the chain's
     fixed costs (the launch of the first trace, the fetch) out;
  3. frame_1m: the headline's fenced and sustained batch of 20 at 1M
     (headline.measure_scale) on the same scene.

The reference chains its traces inside one compiled program to defeat its
relay's dedup; on the card the data dependence keeps the traces in order
on the stream, each ending before the next starts, as a user's loop of
dependent traces would.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C
from radarays_ros_tpu_torch.bench import headline as H


def trace_marginal(st, dev, n_rays: int = 409600, k: int = 5,
                   engine: str = "kernel") -> dict:
    """The chained-marginal stage on the scene st (module doc)."""
    from radarays_ros_tpu_torch.trace.api import trace

    o, d = C.on(dev, *C.radar_fan(n_rays))

    def chain(reps, oo):
        acc = torch.zeros((), device=dev)
        cur = oo
        for _ in range(reps):
            r = trace(st, cur, d, engine=engine, ray_block=2048)
            s = torch.where(torch.isfinite(r.t), r.t, 0.0).sum()
            acc = acc + s
            cur = oo + s * 0.0
        return acc

    def t_of(reps):
        float(chain(reps, o))                          # warm-up
        ts = []
        for i in range(5):
            oo = o + np.float32(i) * 1e-6
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                acc = chain(reps, oo)
                end.record()
                float(acc)
                torch.cuda.synchronize(dev)
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                float(chain(reps, oo))
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t1 = t_of(1)
    C.zero_launches()
    tk = t_of(k)
    launches = C.read_launches()
    marg = (tk - t1) / (k - 1)
    return {"n_triangles": st.n_triangles, "n_rays": n_rays,
            "t1_ms": t1 * 1e3, f"t{k}_ms": tk * 1e3,
            "marginal_trace_ms": marg * 1e3,
            "mrays_per_sec_marginal": n_rays / marg / 1e6,
            "kernel_launches": launches}


def stages(dev, *, chunk_size: int = 256, n_buildings: int = 83000,
           skip=(), label=None, parity_kw=None, marginal_kw=None,
           frame_kw=None, cfg_overrides=None) -> list:
    """Run the stages not in `skip` ("parity", "marginal", "frame") at one
    chunk size; every record carries the `label` fields. Returns the
    records."""
    label = label or {}
    out = []
    if "parity" not in skip:
        par = H.parity_check(chunk_size=chunk_size, device=dev,
                             **(parity_kw or {}))
        out.append(C.emit({"stage": "parity", **label, **par}))
        if not par["exact"]:
            raise RuntimeError(f"parity failed: {par}")
    if {"marginal", "frame"} - set(skip):
        b = C.build_benchmark(n_buildings, chunk_size=chunk_size,
                              cfg_overrides=cfg_overrides, device=dev)
        if "marginal" not in skip:
            out.append(C.emit({"stage": "trace_marginal", **label,
                               **trace_marginal(b.scene, dev,
                                                **(marginal_kw or {}))}))
        if "frame" not in skip:
            m = H.measure_scale(0, scene=b, device=dev, **(frame_kw or {}))
            out.append(C.emit({
                "stage": "frame_1m", **label,
                "sustained_hz": m["sustained_hz"], "best_hz": m["best_hz"],
                "trimmed_median_hz": m["trimmed_median_hz"],
                "n_triangles": m["n_triangles"],
                "kernel_launches": m["kernel_launches"],
                "timed_batches": m["timed_batches"]}))
    return out


def add_stage_args(ap) -> None:
    C.add_device_arg(ap)
    ap.add_argument("--buildings", type=int, default=83000)
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--skip-marginal", action="store_true")
    ap.add_argument("--skip-frame", action="store_true")


def skipped(args) -> tuple:
    return tuple(s for s in ("parity", "marginal", "frame")
                 if getattr(args, f"skip_{s}"))


def main(argv=None, **kw) -> list:
    """kw goes to `stages` (tests cut the run to size)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_stage_args(ap)
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    variant = os.environ.get("RADARAYS_ORDER_VARIANT", "sah")
    out = [C.emit({"stage": "env", "device": C.card_identity(dev),
                   "order_variant": variant})]
    return out + stages(dev, n_buildings=args.buildings, skip=skipped(args),
                        **kw)


if __name__ == "__main__":
    main()
