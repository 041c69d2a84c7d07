"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and the
port (radarays_ros_tpu_torch/). The last line of standard output is one
JSON object: correct, attempted, failed, metrics, device (and, traced,
breakdown), then `check`, each compared number beside its limit, which
are also the last lines of standard error.

Exits non-zero, and prints no result, without a CUDA card (or with fewer
than the cell asks for), or when jax, jaxlib, flax or the JAX package
(radarays_ros_tpu, by whole top-level name) was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build caches at fixed paths inside the checkout (the port's own kernels
# build under build/ already)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench_cache" / sub))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import frozen
    from portbench.harness import Spec, loaded_forbidden, run_cell

    spec = Spec()
    w = spec.workload(args.workload)
    try:
        dev = frozen.require_cards(w["chips"])
    except frozen.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(f"portbench: {frozen.card_identity(dev)}", file=sys.stderr)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   dev, T_START, spec=spec)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
