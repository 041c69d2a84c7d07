"""A/B of the trace chunk size (triangles a chunk) under the SAH ordering
(the twin of the JAX repo's benchmarks/chunksize_ab.py).

    python -m radarays_ros_tpu_torch.bench.chunksize_ab --proxy
        [--device cpu] [--buildings 83000] [--sizes 128,256,384,512]
    python -m radarays_ros_tpu_torch.bench.chunksize_ab --hw
        [--sizes 128,256,384,512] [--skip-parity] [--skip-marginal]
        [--skip-frame]

The chunk size trades K1's lanes tested ((visited chunks) x chunk size a
ray block: finer chunks have tighter boxes) against its fixed cost a visit
(a staged copy, a barrier, the group's vote) and the prep's cost (K2-K4
test every chunk box, so they scale with the chunk count). The reference
tuned 256 on the TPU; these are the card's answers.

  --proxy (host only): the order_ab proxy per size, with the lanes tested
    it predicts (total overlaps x chunk size);
  --hw: parity gate, chained-marginal trace and frame per size, in this
    process (sweep_kernel_ab's stages). A size K1 cannot stage on the
    card is refused by its wrapper before launch (cuda_trace.
    ChunkSizeRefused); the A/B records the refusal and goes on to the next
    size. Any other error, and a size taken that fails the gate, fails the
    run.

K1 stages two chunks of chunk size x 22 floats in shared memory (88 KiB at
512), which its launch asks for past the default 48 KiB.
"""

from __future__ import annotations

import argparse

from radarays_ros_tpu_torch.bench import common as C
from radarays_ros_tpu_torch.bench import order_ab as OA
from radarays_ros_tpu_torch.bench import sweep_kernel_ab as SK
from radarays_ros_tpu_torch.trace.cuda_trace import ChunkSizeRefused


def main(argv=None, **kw) -> list:
    """kw goes to sweep_kernel_ab.stages (tests cut the run to size)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    SK.add_stage_args(ap)
    OA.add_proxy_args(ap)
    ap.add_argument("--sizes", default="128,256,384,512")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    sizes = [int(s) for s in args.sizes.split(",")]
    out = []
    if args.proxy:
        o, d = C.radar_fan(args.rays)
        for tc in sizes:
            h, dt = OA.host_build(args.buildings, tc)
            r = OA.proxy_record(h, o, d, args.t_max, dt)
            out.append(C.emit({
                "stage": "proxy", "chunk_size": tc,
                "total_lanes_m": round(r["total_overlaps"] * tc / 1e6, 2),
                **r}))
    if args.hw:
        out.append(C.emit({"stage": "env", "device": C.card_identity(dev)}))
        for tc in sizes:
            try:
                out += SK.stages(dev, chunk_size=tc,
                                 n_buildings=args.buildings,
                                 skip=SK.skipped(args),
                                 label={"chunk_size": tc}, **kw)
            except ChunkSizeRefused as e:
                out.append(C.emit({"stage": "refused", "chunk_size": tc,
                                   "refused": str(e)}))
    return out


if __name__ == "__main__":
    main()
