"""The one traffic generator: it reads a traffic file (portbench/traffic/
<name>.json), drives the port's public entries in a closed loop for the
window, and keeps, by reservoir sampling drawn from the seed, the answers
the check compares. A traffic file names its kind; each kind is a module
of its own, `portbench/kinds/<kind>.py`, found by name (`kind`), holding
`Cell` (set-up, `warm`, `window`, `free`), `check` and `readings`. The
reference a configuration names (`"reference"`) is found the same way,
`portbench/reference/<name>.py` (`reference`).

Set-up warms every shape the window uses. Nothing compiles in the window.

With trace on, the first `trace_calls` calls of the window run under
torch.profiler; the window then runs on untraced to its end.
"""

from __future__ import annotations

import contextlib
import importlib
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from portbench.tracing import CALL_SPAN, Trace, from_profiler

# the seed's streams
INPUTS, CHECK, STARTS, WARM = range(1, 5)


def kind(name: str):
    """The module of a traffic kind, portbench/kinds/<name>.py."""
    return importlib.import_module(f"portbench.kinds.{name}")


def reference(conf: dict):
    """The reference module the configuration names."""
    return importlib.import_module(f"portbench.reference.{conf['reference']}")


def stream(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, k])


def torch_seed(seed: int, k: int) -> int:
    return int(stream(seed, k).integers(2**62))


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    calls: int = 0
    attempted: int = 0      # the result line's: frames, or fits
    frames: int = 0
    evals: int = 0
    latency_s: list = field(default_factory=list)   # a call's or a fit's
    host_s: list = field(default_factory=list)      # inside the entry call
    traced_calls: int = 0
    trace: Optional[Trace] = None
    kept: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Reservoir:
    """k items (frames, fits) drawn uniformly from a stream of unknown
    length, by the seed's CHECK stream (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.n = k, rng, [None] * k, 0

    def slot(self) -> Optional[int]:
        """The slot the next item takes, or None."""
        i, self.n = self.n, self.n + 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def kept(self) -> list:
        return [x for x in self.items if x is not None]


class Profiled:
    """torch.profiler over the first n calls of a window (none when n is
    0); its events are reduced once the window has closed."""

    def __init__(self, n: int, device):
        self.n, self.prof, self.done = n, None, None
        if n:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def span(self, k: int):
        if self.prof is not None and k < self.n:
            return torch.profiler.record_function(CALL_SPAN)
        return contextlib.nullcontext()

    def stop_after(self, k: int, win: Window, frames: int, evals: int):
        if self.prof is not None and k == self.n - 1:
            self.prof.__exit__(None, None, None)
            win.traced_calls = self.n
            self.done, self.prof = (self.prof, frames, evals), None

    def close(self, win: Window, frames: int, evals: int):
        """After the window: stop a profiler still on, reduce its events."""
        if self.prof is not None:
            self.stop_after(self.n - 1, win, frames, evals)
        if self.done is not None:
            win.traced_calls = min(self.n, win.calls)
            win.trace = from_profiler(*self.done)


def cone_draws(gen: torch.Generator, n: int, cfg):
    """(theta, radial), each (n, n_samples), on the generator's device:
    theta ~ U(-pi, pi); radial ~ U(0, 1) (distributions D1, D2) or N(0, 1)
    (D3, D4), as the upstream cone sampler draws them."""
    shape = (n, cfg.n_samples)
    theta = torch.rand(shape, generator=gen, device=gen.device) \
        * (2 * math.pi) - math.pi
    draw = torch.rand if cfg.beam_sample_dist < 2 else torch.randn
    return theta, draw(shape, generator=gen, device=gen.device)


def fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
