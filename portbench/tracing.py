"""What a traced window leaves for the per-layer readers: the device events
of torch.profiler (kernels, copies, sets) and the host's ops, in the
profiler's clock, reduced in-process (nothing is read from disk), plus the
benchmark's own spans around its calls into the port.

The traced window runs from the start of the first traced call to the end
of the last (each call ends with its result on the host), as the
benchmark's `portbench.call` spans mark them.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np

from portbench.frozen import busy, group_name

CALL_SPAN = "portbench.call"
# the port's hand-written kernels (its csrc/*.cu), by group name: K1 the
# sweep, K2/K3/K4 the preps, K5 the binning and its backward, and the
# material lookup's backward
HANDWRITTEN = ("sweep_kernel", "prep_hier_kernel", "coarse_words_kernel",
               "prep_flat_kernel", "bin_kernel", "bin_bwd_kernel",
               "table_grad_kernel", "table_fold_kernel")
GAPS_ATTRIBUTED = 200


class Trace(NamedTuple):
    device: list        # [(name, start_us, end_us)] every device event
    host: list          # [(name, start_us, end_us)] host ops
    window_us: tuple    # (start, end) of the traced calls
    frames: int         # frames the traced calls produced (frame cells)
    evals: int          # objective evaluations (fit cells)

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def kernels(self) -> list:
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        a, b = self.window_us
        spans = [(max(s, a), min(e, b)) for _, s, e in self.device
                 if e > a and s < b]
        return busy(spans)[0] / 1e6 if spans else 0.0

    def group_s(self) -> collections.Counter:
        out = collections.Counter()
        for name, s, e in self.device:
            out[group_name(name)] += (e - s) / 1e6
        return out

    def idle_gaps(self) -> list:
        """[(start_us, end_us)] of the device's idle gaps in the window."""
        a, b = self.window_us
        spans = sorted((s, e) for _, s, e in self.device)
        gaps, end = [], a
        for s, e in spans:
            if s > end:
                gaps.append((end, min(s, b)))
            end = max(end, e)
        if end < b:
            gaps.append((end, b))
        return [g for g in gaps if g[1] > g[0]]

    def breakdown(self) -> dict:
        """The ten device groups that took most time, and the idle time of
        the longest gaps by the innermost host op at each gap's middle."""
        ops = [[n, s] for n, s in self.group_s().most_common(10)]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        gaps = gaps[:GAPS_ATTRIBUTED]
        by = collections.Counter()
        if self.host:
            st = np.array([h[1] for h in self.host])
            en = np.array([h[2] for h in self.host])
            for g0, g1 in gaps:
                mid = (g0 + g1) / 2
                ix = np.nonzero((st <= mid) & (en >= mid))[0]
                name = "(no host op)"
                if ix.size:
                    name = self.host[ix[np.argmin(en[ix] - st[ix])]][0]
                by[name[:80]] += (g1 - g0) / 1e6
        return {"device_ops": ops,
                "idle_gaps": [[n, s] for n, s in by.most_common(10)]}


def from_profiler(prof, frames: int, evals: int) -> Optional[Trace]:
    """The Trace of one torch.profiler object; None when it holds no call
    span."""
    from torch.autograd import DeviceType

    dev, host, calls = [], [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the device side of a host span (the benchmark's, the
            # optimizer's step) is an annotation, not work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("portbench.", "Optimizer."))):
                dev.append(rec)
        elif e.device_type == DeviceType.CPU:
            (calls if e.name == CALL_SPAN else host).append(rec)
    if not calls:
        return None
    window = (min(c[1] for c in calls), max(c[2] for c in calls))
    return Trace(dev, host, window, frames, evals)
