"""The readings the limits of portbench/limits/ are set from, at a cell's own
size on the card (the benchmark's runs do not run this):

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 ...
        [--seconds 2] [--out chiprun_out/calibrate.jsonl]

For each seed, in one process: the cell's set-up and a short window at its
own load, then each compared number of
  program  the window's answers against the reference (float32, TF32 off),
  control  the reference computed with TF32 matmuls, put in the program's
           place, against the same reference,
  f64      the window's answers against the reference in float64 (for
           the record),
and, in fit cells, the faults read in the reference put in the program's
place: half of the batch (frames) left out of the objective, and (gradient
fits) the state left unchanged; each kind's `readings`
(portbench/kinds/<kind>.py). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from portbench import generator as G
from portbench.harness import Spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = Spec()
    w = spec.workload(args.workload)
    conf, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    dev = torch.device("cuda", 0)
    kind = G.kind(traffic["kind"])
    out = Path(args.out) if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = kind.Cell(conf, traffic, seed, dev)
        cell.warm()
        setup_s = time.perf_counter() - t0 - cell.reference_s
        win = cell.window(args.seconds, 0)
        cell.free()
        torch.cuda.empty_cache()
        line = dict(workload=args.workload, seed=seed, setup_s=setup_s,
                    window_s=win.seconds, calls=win.calls,
                    **kind.readings(cell, win, conf, traffic, seed, dev))
        print(json.dumps(line), flush=True)
        if out:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")
        del cell, win
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
