"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources have a plain C interface and are compiled by nvcc into one
shared library, loaded with ctypes — no PyTorch headers, so the build takes
seconds. Each source is compiled by its own nvcc process, all started
together, and the objects are then linked. The library goes to build/radarays_torch_kernels/ under the
repository root, named by a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

Flags: sm_90a (Hopper), -O3, and -fmad=false: nvcc contracts a*b+c into one
FMA by default, which changes the rounding of the sweep's inside test and of
the denoise tap sums and would cost bitwise agreement with the plain torch
versions. No fast-math.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import NamedTuple

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("sweep.cu", "prep.cu", "bin.cu", "lookup.cu")
_HEADERS = ("slab.cuh",)    # included by the sources: part of the hash
_BUILD_DIR = _CSRC.parent.parent / "build" / "radarays_torch_kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argtypes (every entry returns a cudaError_t)
_SIGNATURES = {
    "rr_sweep": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                 _I, _I, _I, _F, _F, _F, _P, _P, _P, _I, _P],
    "rr_sweep_occupancy": [_I, _I, _PI],
    "rr_coarse_words": [_P, _P, _I, _P, _P, _P, _I, _I, _F, _P, _P],
    "rr_prep_hier": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P,
                     _P],
    "rr_prep_flat": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "rr_bin": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    "rr_bin_bwd": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    "rr_table_grad": [_P, _P, _LL, _I, _P, _P, _P],
}


class Build(NamedTuple):
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float     # nvcc wall time; 0.0 when the library was cached
    log: str           # nvcc/ptxas output (registers, shared memory, spills),
                       # kept beside the library


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile (if needed) and load the kernel library; cached per process."""
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in (*srcs, *(_CSRC / x for x in _HEADERS)):
        h.update(s.read_bytes())
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _BUILD_DIR / f"libradarays_torch_kernels-{h.hexdigest()[:16]}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        objs = [path.with_suffix(f".{s.stem}.{os.getpid()}.o") for s in srcs]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        log_path.write_text(log)
        os.replace(tmp, path)
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Build(lib, path, seconds, log)


def check_tensors(name: str, *tensors, dtypes) -> None:
    """Raise unless each tensor is a contiguous CUDA tensor of its dtype."""
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous CUDA {dt}, got "
                             f"{t.dtype} on {t.device} (contiguous="
                             f"{t.is_contiguous()})")


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as an int pointer (the
    raw handle, without building a torch.cuda.Stream object per call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
