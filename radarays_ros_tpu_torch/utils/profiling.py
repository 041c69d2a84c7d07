"""Tracing/profiling (counterpart of radarays_ros_tpu/utils/profiling.py).

  * `StageTimer` — named wall-clock stages, fenced with
    `torch.cuda.synchronize` when the fence is a CUDA tensor (kernel launches
    return before the device finishes; an unfenced timer measures the
    enqueue), and a per-stage summary in the reference GPU engine's
    fraction format (RadarGPU.cpp:854).
  * `trace_context` — `torch.profiler` capture of CPU and CUDA activity,
    exported as a Chrome trace into `trace_dir`.
  * `annotate` — `torch.profiler.record_function`, so pipeline stages show
    up named in profiles.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def _fence(x) -> None:
    """Wait for the device work behind `x` (a tensor or a tuple/list/dict
    of them) when any of it lives on a CUDA device."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _fence(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _fence(v)


class StageTimer:
    """Accumulating named wall-clock stages.

    with timer.stage("trace", fence=out_tensor):
        out_tensor = ...
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @property
    def total(self) -> float:
        return sum(self.totals.values())

    def summary(self) -> str:
        """Per-stage fractions, the RadarGPU.cpp:854 print format."""
        tot = max(self.total, 1e-12)
        parts = [
            f"{k}: {v * 1e3:.2f}ms ({v / tot:.1%})"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return f"total {tot * 1e3:.2f}ms | " + ", ".join(parts)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None):
    """torch.profiler capture (CPU, plus CUDA when a device is present)
    into `trace_dir`/trace.json when trace_dir is given."""
    if trace_dir is None:
        yield
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


def annotate(name: str):
    """Named region for profiles (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
