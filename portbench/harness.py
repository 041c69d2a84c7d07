"""One run of one cell: set-up, the window, the check, the metrics and the
result line. Everything a cell is made of is found by name:

  BENCHMARK.json                 the cells, configurations and metrics
  portbench/configs/<config>.json   (its `file` in BENCHMARK.json)
  portbench/traffic/<traffic>.json  read by portbench/generator.py and
                                    the kind it names, portbench/kinds/
                                    <kind>.py (the cell, its check)
  portbench/reference/<name>.py     the reference a configuration names
  portbench/scenes/<kind>.py        the scene a configuration names
  portbench/metrics/<metric>.py     one reader a metric: read(run); a
                                    metric a.b.c without its own file is
                                    read by a.b.py (or a.py)
  portbench/limits/<cell>.json      the limit of each compared number

A cell added as data files and BENCHMARK.json entries runs without an edit
here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench import check as CK
from portbench import generator as G

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "radarays_ros_tpu")


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        self.data = json.loads(Path(path).read_text())
        self.root, self.base = Path(path).parent, base

    def _named(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"]
                           ).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.base / "traffic" / f"{name}.json"
                           ).read_text())

    def limits(self, workload: str) -> dict:
        return CK.load_limits(self.base / "limits" / f"{workload}.json")

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str):
        """metrics/<metric>.py, or the reader its name shares: a.b.c is
        read by a.b.c.py, else a.b.py, else a.py."""
        parts = metric.split(".")
        for n in range(len(parts), 0, -1):
            path = self.base / "metrics" / (".".join(parts[:n]) + ".py")
            if path.exists():
                break
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


@dataclass
class Run:
    """What a metric reader reads."""
    workload: str
    kind: str
    setup_s: float
    window: G.Window
    trace: Optional[object] = None


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, spec: Optional[Spec] = None,
             conf: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None, log=None) -> dict:
    """One run; returns the result line's object. conf, traffic and limits
    replace the files (tests)."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    spec = spec or Spec()
    w = spec.workload(workload)
    conf = conf or spec.config(w["config"])
    traffic = traffic or spec.traffic(w["traffic"])
    limits = spec.limits(workload) if limits is None else limits
    device = torch.device(device)
    kind = G.kind(traffic["kind"])
    cell = kind.Cell(conf, traffic, seed, device)
    cell.warm()
    # the reference's own seconds at set-up (a fit's targets) are not the
    # program's set-up
    setup_s = time.perf_counter() - t_start - cell.reference_s
    log(f"portbench: {workload} set-up {setup_s:.3f} s "
        f"{json.dumps(cell.sys.build_s)}; the reference's targets "
        f"{cell.reference_s:.3f} s, not counted")
    win = cell.window(seconds, traffic["trace_calls"] if trace else 0)
    q = np.percentile(win.latency_s, [0, 25, 50, 75, 100]) * 1e3
    log(f"portbench: window {win.seconds:.3f} s, {win.calls} calls, "
        f"{win.frames} frames, {win.evals} evaluations; a call's ms "
        f"(min, quartiles, max) {np.round(q, 3).tolist()}")
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.free()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums, failed = kind.check(cell, win, conf, traffic, seed, device,
                              limits)
    log(f"portbench: check {time.perf_counter() - t0:.3f} s")
    run = Run(workload, traffic["kind"], setup_s, win, win.trace)
    metrics = {}
    for m in (spec.per_layer(workload) if trace
              else spec.end_to_end(workload)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(limits) and all(
        k in limits and v <= limits[k] for k, v in nums.items())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if trace and win.trace is not None:
        device_info["busy_s"] = win.trace.busy_s()
        device_info["window_s"] = win.trace.window_s
        out["breakdown"] = win.trace.breakdown()
    out["check"] = {k: {"value": v, "limit": limits.get(k)}
                    for k, v in nums.items()}
    for k, v in out["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return out
