"""Compiled calls: a function of tensors captured once as a CUDA graph and
replayed with new values (the port's counterpart of jax.jit's "one
program" for the frame and the fit's value-and-grad; the reference's
sim/pipeline.py:382, 427 and opti/optimize.py:170-177).

A `Compiled` wraps `fn(*args)`, whose arguments are tensors, None, or
tuples and NamedTuples of those. Each distinct signature of the arguments
(the tree's structure, every tensor's shape and dtype, every other
value) gets its own graph; within a signature the values are free, as a
jitted function's traced arguments are:

  * the first call of a signature copies the arguments into static
    buffers on the device, runs `fn` on them eagerly on a side stream
    (the warm-up PyTorch's graph recipe asks for: the lazy nvcc build,
    the lru_caches, cuBLAS's workspace), returns that run's result, and
    then captures `fn` on the same buffers into a graph with a private
    memory pool;
  * every later call copies its values into the static buffers, replays
    the graph and returns clones of the static outputs (a second call
    never overwrites the first call's result, as JAX returns fresh
    arrays).

Tensors that `fn` reads in place (the scene, fixed targets) are either
closed over, and held by the Compiled, or passed as `static` arguments,
`fn(*static, *args)`: those key the graph by their identity, shapes and
values, and the key and the graph hold them, so that a tensor a graph
reads is not freed while the graph lives (pipeline.simulate_frames_jit
passes the scene and cfg so). There is no eager fallback: a call on the
card replays a graph or raises, whatever the capture or the replay
raises. A call whose tensors all lie on the CPU runs `fn` eagerly, as
every plain version does.

Launch counts: the kernel wrappers count launches in Python, which a
replay does not run. A capture records each wrapper's counters (COUNTERS:
its launches, and K1's launches with row slices and those over
supergroups of more than one chunk) and takes them back (nothing ran),
and every replay adds them, so `<wrapper>.launches` stays the count of
kernels the card ran.

Spans (utils/profiling.py): a graph's build is `rr.graph.build`, each
replay's launch `rr.graph.replay`.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Optional

import torch

from radarays_ros_tpu_torch.utils.profiling import annotate


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name (each counts its
    launches in `.launches`)."""
    from radarays_ros_tpu_torch.image.cuda_draw import bin_bwd, bin_signals
    from radarays_ros_tpu_torch.sim.lookup import table_grad
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    return {"sweep": CT.sweep, "prep_hier": CT.prep_hier,
            "coarse_words": CT.coarse_words, "prep_flat": CT.prep_flat,
            "bin": bin_signals, "bin_bwd": bin_bwd, "table_grad": table_grad}


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


# what a replay adds to
COUNTERS = ("launches", "split_launches", "grouped_launches")


def _counts(wrappers) -> dict:
    """{(kernel, counter): value} of every wrapper's COUNTERS it has."""
    return {(k, c): getattr(w, c) for k, w in wrappers.items()
            for c in COUNTERS if hasattr(w, c)}


# ------------------------------------------------------------ arguments

def flatten(tree) -> tuple:
    """(tensor leaves, structure): tuples and NamedTuples recurse; every
    other value is kept in the structure, which is hashable when those
    values are."""
    leaves = []

    def walk(x):
        if torch.is_tensor(x):
            leaves.append(x)
            return ("T", tuple(x.shape), x.dtype)
        if isinstance(x, tuple):
            kind = type(x) if hasattr(x, "_fields") else tuple
            return (kind, tuple(walk(v) for v in x))
        return ("V", x)

    return leaves, walk(tree)


def unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def build(s):
        if s[0] == "T":
            return next(it)
        if s[0] == "V":
            return s[1]
        vals = [build(v) for v in s[1]]
        return tuple(vals) if s[0] is tuple else s[0](*vals)

    return build(spec)


# ------------------------------------------------------------ one graph

class Graph:
    """One captured call of fn(*static, *args): its static inputs and
    outputs, the CUDA graph, each kernel's launches a replay, the
    capture's seconds and the memory its private pool reserved (MiB).
    It holds fn and `static`, which it reads in place."""

    def __init__(self, fn: Callable, static: tuple, spec, leaves, device):
        with annotate("rr.graph.build"):
            self.fn, self.static = fn, static
            self.device = torch.device(device)
            with torch.no_grad():
                self.static_in = [torch.empty(t.shape, dtype=t.dtype,
                                              device=self.device).copy_(t)
                                  for t in leaves]
            args = unflatten(spec, self.static_in)
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                first = fn(*static, *args)            # the warm-up, eager
            cur.wait_stream(side)
            first_leaves, self.out_spec = flatten(first)
            for t in first_leaves:
                # the warm-up's result is this call's: the caller's stream
                # uses it after the side stream made it
                t.record_stream(cur)
            self.first = first

            wrappers = kernel_wrappers()
            before = _counts(wrappers)
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            try:
                # torch.cuda.graph synchronizes and empties the allocator's
                # cache as it starts: what is reserved from here on is the
                # private pool's
                with torch.cuda.graph(self.graph):
                    reserved = torch.cuda.memory_reserved(self.device)
                    out = fn(*static, *args)
            finally:
                # nothing ran: take back the launches the capture counted
                after = _counts(wrappers)
                for (k, c), n in before.items():
                    setattr(wrappers[k], c, n)
            self.capture_s = time.perf_counter() - t0
            self.pool_mib = (torch.cuda.memory_reserved(self.device)
                             - reserved) / 2**20
            delta = {kc: after[kc] - n for kc, n in before.items()
                     if after[kc] != n}
            self.launches = {k: n for (k, c), n in delta.items()
                             if c == "launches"}
            # what a replay adds to each wrapper's counters
            self.counted = [(wrappers[k], c, n)
                            for (k, c), n in delta.items()]
            self.static_out, out_spec = flatten(out)
            if out_spec != self.out_spec:
                raise RuntimeError("the captured call's outputs differ in "
                                   "structure from the warm-up's")
            self.replays = 0

    def take_first(self):
        """The warm-up's result, once (the capturing call returns it)."""
        first, self.first = self.first, None
        return first

    def __call__(self, leaves):
        with torch.no_grad():
            for s, t in zip(self.static_in, leaves):
                s.copy_(t)
        with annotate("rr.graph.replay"):
            self.graph.replay()
        self.replays += 1
        for w, c, n in self.counted:
            setattr(w, c, getattr(w, c) + n)
        return unflatten(self.out_spec, [t.clone() for t in self.static_out])

    def info(self) -> dict:
        return dict(capture_s=self.capture_s, pool_mib=self.pool_mib,
                    launches_per_replay=dict(self.launches),
                    replays=self.replays)


# ------------------------------------------------------------ Compiled

GRAPHS_KEPT = 4     # graphs a Compiled keeps, each holding its pool


class Same:
    """A key part equal only to a part of the same object (identity). It
    holds the object, so that the object's id is not reused while a key
    names it."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, Same) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


class Compiled:
    """fn(*static, *args)'s calls as CUDA graphs (module doc): one graph a
    key, the GRAPHS_KEPT used last kept, least recently used first out;
    `captures` counts every capture made. A call runs on the card of the
    first tensor of `static` or `args` that lies on one, else eagerly."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0

    @staticmethod
    def key(args: tuple, static: tuple = ()) -> tuple:
        """A call's graph: the structure, shapes and dtypes of `args` (not
        their values), and `static` — its other values, and its tensors'
        shapes and identities (the graph reads them in place; the key
        holds them)."""
        held, static_spec = flatten(static)
        return (static_spec, tuple(map(Same, held)), flatten(args)[1])

    def __call__(self, *args, static: tuple = ()):
        leaves, spec = flatten(args)
        device = next((t.device for t in flatten(static)[0] + leaves
                       if t.is_cuda), None)
        if device is None:
            return self.fn(*static, *args)
        key = self.key(args, static)
        g = self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
            return g(leaves)
        g = Graph(self.fn, static, spec, leaves, device)
        self.captures += 1
        self.graphs[key] = g
        while len(self.graphs) > GRAPHS_KEPT:
            self.graphs.popitem(last=False)
        return g.take_first()

    def last(self) -> Optional[Graph]:
        """The graph used last (None before the first capture)."""
        return next(reversed(self.graphs.values()), None)

    def clear(self) -> None:
        self.graphs.clear()
