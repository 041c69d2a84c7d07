"""Tracing/profiling (counterpart of radarays_ros_tpu/utils/profiling.py).

  * `annotate` — the port's one span: `torch.profiler.record_function`
    while a profiler is active, so the span lands in the profiler's events
    on the clock of its CUDA events; otherwise a shared no-op that
    allocates and dispatches nothing. Run under `torch.profiler` and
    export its trace to see the spans (the reference's `trace_context`).
    The port's span names start with `rr.`:

      rr.frame.entry   simulate_frame(s)_jit, from the call to its return
                       (the outermost call only)
      rr.graph.build   sim/graphs.py:Graph's build: static buffers, the
                       eager warm-up, the capture
      rr.graph.replay  a graph's replay (its launch)
      rr.frame.fetch   a compiled frame's u8 images to the host on the
                       card: the page-locked copy and the wait for it
                       (inside rr.frame.entry, after rr.graph.replay)
      rr.fit.run       optimize_gradient, optimize_black_box
      rr.fit.eval      one evaluation of a fit (gradient: the compiled
                       step through loss.item(); black box: one call of f)

    None lies inside a captured body: a host span there would fire at
    capture only, never at replay.
  * `StageTimer` — named wall-clock totals and counts (the per-frame print
    of `Radar(verbose_timing=True)`).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span while a profiler is active, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StageTimer:
    """Accumulating named wall-clock totals: `add(name, seconds)`."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1
