"""Device-time profile of one KAIST-preset batch of 20 frames (the twin of
the JAX repo's benchmarks/profile_frame.py).

    python -m radarays_ros_tpu_torch.bench.profile_frame [--device cpu]
        [--buildings 83000] [--top 25]

One warm-up batch, then one fenced batch (its checksum fetched) under
torch.profiler (CPU and, on the card, CUDA activity). Prints one JSON
line: the device time grouped by kernel-name prefix (the name up to its
first template or argument list), the top device ops, the device's busy
and idle share of the window from its first to its last event, the
copies that synchronize the host (pageable, or device to host) counted by
the host op that issued them, and the host's synchronizing runtime calls.
On the CPU (--device cpu) the groups are the host ops' own times and the
device figures are null.

The reference parses the newest trace file of a directory that
accumulates runs, and learned that globbing them all shows stale data
(its lesson 5). Here nothing is read from disk: the figures come from the
profiler object of this run, so they hold this batch and nothing else.
"""

from __future__ import annotations

import argparse
import collections
import re

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def group_name(name: str) -> str:
    """A kernel's group: its name without a leading "void " and anonymous
    namespaces, up to the first '<' or '(' (template arguments, argument
    list), at most 60 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:60]


def _busy(events) -> tuple:
    """(busy us, window us) of the union of the events' time ranges."""
    busy, end = 0.0, float("-inf")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy, end - spans[0][0]


def _issuer(e) -> str:
    names = []
    while e is not None and len(names) < 3:
        names.append(e.name)
        e = e.cpu_parent
    return " < ".join(names)


def profile_table(prof, dev: torch.device, top: int) -> dict:
    """The figures of the module doc from one profiler object."""
    from torch.autograd import DeviceType

    evs = prof.events()
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    if dev.type == "cuda":
        work = [e for e in evs if e.device_type == DeviceType.CUDA]
        ms = [(e.name, e.time_range.elapsed_us() / 1e3) for e in work]
    else:
        # the host is the device: each op's own time, without its children
        work = cpu
        ms = [(e.name, e.self_cpu_time_total / 1e3) for e in cpu]
    groups, ops = collections.Counter(), collections.Counter()
    for name, t in ms:
        groups[group_name(name)] += t
        ops[name[:100]] += t
    total = sum(groups.values())
    out = dict(
        device_total_ms=total,
        top_groups=[dict(op=n, ms=t, pct=100 * t / total)
                    for n, t in groups.most_common(top)],
        top_ops=[dict(op=n, ms=t, pct=100 * t / total)
                 for n, t in ops.most_common(top)],
        bin_calls=sum(e.name == "_Bin" for e in cpu),
        device_busy_ms=None, device_window_ms=None, device_idle_share=None,
        kernels=None, sync_copies_by_op={}, sync_calls={})
    if dev.type == "cuda" and work:
        busy, window = _busy(work)
        sync = ("Pageable", "DtoH")
        out.update(
            device_busy_ms=busy / 1e3, device_window_ms=window / 1e3,
            device_idle_share=1.0 - busy / window,
            kernels=sum(not e.name.startswith(("Memcpy", "Memset"))
                        for e in work),
            # the profiler's own buffer marker lists the copies it interrupts
            sync_copies_by_op=dict(collections.Counter(
                _issuer(e) for e in cpu for k in e.kernels
                if k.name.startswith("Memcpy") and any(s in k.name
                                                       for s in sync)
                and e.name != "Activity Buffer Request")),
            sync_calls=dict(collections.Counter(
                e.name for e in cpu if e.name in SYNC_CALLS)))
    return out


def profile_batch(bench, dev: torch.device, batch: int = 20,
                  top: int = 25) -> dict:
    """One warm-up batch of `batch` frames, then one under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from radarays_ros_tpu_torch.sim.pipeline import simulate_frames
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    poses = torch.from_numpy(np.tile(make_pose([0.0, 0.0, 2.0]),
                                     (batch, 1)))
    gen = torch.Generator(dev).manual_seed(0)

    def run():
        return C.frame_checksum(simulate_frames(bench.scene, bench.params,
                                                bench.cfg, poses,
                                                generator=gen))

    int(run())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    C.fence(dev)
    C.zero_launches()
    with profile(activities=acts) as prof:
        checksum = int(run())
        C.fence(dev)
    return dict(checksum=checksum, kernel_launches=C.read_launches(),
                **profile_table(prof, dev, top))


def main(argv=None, *, cfg_overrides=None) -> dict:
    """cfg_overrides cuts the preset to size (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    C.add_device_arg(ap)
    ap.add_argument("--buildings", type=int, default=83000)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    b = C.build_benchmark(args.buildings, cfg_overrides=cfg_overrides,
                          device=dev)
    return C.emit(dict(bench="profile_frame", device=C.card_identity(dev),
                       n_triangles=b.scene.n_triangles, batch=20,
                       **profile_batch(b, dev, top=args.top)))


if __name__ == "__main__":
    main()
