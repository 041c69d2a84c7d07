"""Spawn the ranks of a layout: `run_ranks` starts world_size processes
(torch.multiprocessing, spawn context), joins them in one default process
group and returns rank 0's result.

The group is initialised from a file store in a fresh temporary directory
(TCP ports collide when several runs share a host), with the backend the
caller names: "gloo" (CPU tensors, and CUDA tensors staged through the
host) or "nccl" (one card per rank). Every rank gets its device: "cpu", or
for "cuda" the card rank % device_count, so ranks share a single card.

The function a rank runs must be importable by name (a module-level
function of a module, not of a test file): spawned processes import it
afresh.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_TIMEOUT_S = 600.0   # a collective that waits longer fails


def rank_device(device, rank: int) -> torch.device:
    """The device of a rank: "cuda" without an index is card
    rank % device_count; anything else as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, fn, world_size: int, backend: str, device,
               tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    try:
        out = fn(rank, world_size, dev, *args)
        if rank == 0:
            path = os.path.join(tmp, "rank0.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".tmp", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *, backend: str, device, args=()):
    """Run fn(rank, world_size, device, *args) in world_size spawned
    processes of one process group and return what rank 0's call returned
    (numpy arrays and plain values; it is pickled). A rank that raises
    ends the others and raises here, with its traceback; a collective
    that waits longer than _TIMEOUT_S fails. For CUDA the kernels are built
    here first, so the ranks load the library instead of running nvcc
    each."""
    if torch.device(device).type == "cuda":
        from radarays_ros_tpu_torch import cuda_build

        cuda_build.build()
    with tempfile.TemporaryDirectory(prefix="radarays_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(fn, world_size, backend, device,
                                             tmp, tuple(args)),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
