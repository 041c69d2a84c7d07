"""The port's host scene builder in C++ (src/builder.cpp), bound with ctypes
(counterpart of radarays_ros_tpu/native/builder.py).

The SAH leaf ordering, the chunk AABBs, the plane equations and the two
device tables of a scene, and the OBJ reader, each bit-equal to the NumPy
function of the port it replaces (geom/scene.py, geom/mesh.py:_load_obj);
the median split of RADARAYS_ORDER_VARIANT=median holds the reference's
looser contract (the same leaf quality). The NumPy build stays as the plain
version the tests hold the library against, and RADARAYS_NO_NATIVE=1
selects it.

Two departures from the reference's bridge:

  * the library is built at first use, by the system C++ compiler, into
    build/radarays_torch_native/ (no make step), named by a hash of the
    source and the flags, and written to a temporary file that is renamed
    into place, so that concurrent processes may race on the first build;
    -march is left out, so a library built on another CPU runs here too;
  * a build or load that fails raises with the compiler's output, where
    the reference warns and falls back to NumPy: no fallback hides which
    builder ran.

The reference's rr_sweep_table_fused and rr_tri_table pack the TPU's bf16
split-exact tables, which the port does not store (geom/scene.py docstring);
their place is taken by rr_edge_coefficients and rr_fetch_rows, which make
the port's f32 tables.
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

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "src" / "builder.cpp"
_BUILD_DIR = _SRC.parents[3] / "build" / "radarays_torch_native"
# -ffp-contract=off: no product and sum fused into an FMA, which would
# round otherwise than NumPy
_FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-fopenmp",
          "-shared")

# the bytes the builders produce (src/builder.cpp:rr_builder_version must
# equal it, since the NumPy build gives the same bytes)
BUILDER_VERSION = 1

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "rr_builder_version": ([], ctypes.c_int64),
    "rr_sah_split_order": ([_P, _P, _P, _I64, _I64, _P], None),
    "rr_median_split_order": ([_P, _I64, _I64, _P], None),
    "rr_chunk_aabbs": ([_P, _I64, _I64, _P, _P], None),
    "rr_triangle_planes": ([_P, _I64, _P, _P], None),
    "rr_edge_coefficients": ([_P, _I64, _P], None),
    "rr_fetch_rows": ([_P, _P, _P, _I64, _P], None),
    "rr_obj_count": ([ctypes.c_char_p, _P, _P, _P, _P], ctypes.c_int),
    "rr_obj_parse": ([ctypes.c_char_p, _P, _P, _P, _I64, _I64],
                     ctypes.c_int),
}


class Build(NamedTuple):
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float     # compiler wall time; 0.0 when the library was there


def enabled() -> bool:
    """Whether scene builds use the library: RADARAYS_NO_NATIVE=1 selects
    the NumPy build."""
    return os.environ.get("RADARAYS_NO_NATIVE", "0") != "1"


def _compiler() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the host "
                       "scene builder is compiled at first use; set "
                       "RADARAYS_NO_NATIVE=1 for the NumPy build")


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile (if needed) and load the library; cached per process."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    path = _BUILD_DIR / f"libradarays_torch_native-{h.hexdigest()[:16]}.so"
    seconds = 0.0
    if not path.exists():
        cxx = _compiler()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the host scene builder failed "
                               f"({cxx}, exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Build(lib, path, seconds)


def builder_version() -> int:
    return int(build().lib.rr_builder_version())


def _f32(a, shape_tail, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.shape[1:] != shape_tail:
        raise ValueError(f"{name} must be shaped (N, {', '.join(map(str, shape_tail))}), "
                         f"got {a.shape}")
    return a


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def sah_split_order(centers, tri_lo, tri_hi, chunk_size: int) -> np.ndarray:
    """SAH leaf ordering (the permutation of geom/scene.py:
    _median_split_order_sah) of (N, 3) centroids with per-triangle AABBs
    (N, 3) x 2; N must be a multiple of chunk_size."""
    centers = _f32(centers, (3,), "centers")
    tri_lo = _f32(tri_lo, (3,), "tri_lo")
    tri_hi = _f32(tri_hi, (3,), "tri_hi")
    n = centers.shape[0]
    if chunk_size < 1 or n % chunk_size or tri_lo.shape[0] != n \
            or tri_hi.shape[0] != n:
        raise ValueError(f"sah_split_order: {n} centroids, {tri_lo.shape[0]}"
                         f"/{tri_hi.shape[0]} boxes, chunk {chunk_size}")
    out = np.empty(n, np.int64)
    build().lib.rr_sah_split_order(_ptr(centers), _ptr(tri_lo), _ptr(tri_hi),
                                   n, chunk_size, _ptr(out))
    return out


def median_split_order(centers, chunk_size: int) -> np.ndarray:
    """Median-split leaf ordering of (N, 3) centroids (the contract of
    geom/scene.py:_median_split_order); N a multiple of chunk_size."""
    centers = _f32(centers, (3,), "centers")
    n = centers.shape[0]
    if chunk_size < 1 or n % chunk_size:
        raise ValueError(f"median_split_order: {n} centroids, chunk "
                         f"{chunk_size}")
    out = np.empty(n, np.int64)
    build().lib.rr_median_split_order(_ptr(centers), n, chunk_size,
                                      _ptr(out))
    return out


def chunk_aabbs(verts, chunk_size: int):
    """(C * chunk, 3, 3) verts -> ((C, 3) lo, (C, 3) hi)."""
    verts = _f32(verts, (3, 3), "verts")
    if chunk_size < 1 or verts.shape[0] % chunk_size:
        raise ValueError(f"chunk_aabbs: {verts.shape[0]} triangles, chunk "
                         f"{chunk_size}")
    c = verts.shape[0] // chunk_size
    lo = np.empty((c, 3), np.float32)
    hi = np.empty((c, 3), np.float32)
    build().lib.rr_chunk_aabbs(_ptr(verts), c, chunk_size, _ptr(lo), _ptr(hi))
    return lo, hi


def triangle_planes(verts):
    """(N, 3, 3) verts -> (normals (N, 3), planes_o (4N, 4)), the layout of
    geom/scene.py:_triangle_planes."""
    verts = _f32(verts, (3, 3), "verts")
    n = verts.shape[0]
    normals = np.empty((n, 3), np.float32)
    planes_o = np.empty((4 * n, 4), np.float32)
    build().lib.rr_triangle_planes(_ptr(verts), n, _ptr(normals),
                                   _ptr(planes_o))
    return normals, planes_o


def edge_coefficients(planes_o) -> np.ndarray:
    """(4T, 4) plane rows -> (T, 22) f32 (geom/scene.py:edge_coefficients)."""
    planes_o = _f32(planes_o, (4,), "planes_o")
    if planes_o.shape[0] % 4:
        raise ValueError(f"planes_o has {planes_o.shape[0]} rows, not 4 a "
                         "triangle")
    T = planes_o.shape[0] // 4
    out = np.empty((T, 22), np.float32)
    build().lib.rr_edge_coefficients(_ptr(planes_o), T, _ptr(out))
    return out


def fetch_rows(verts, normals, obj_ids) -> np.ndarray:
    """(T, 16) winner records (geom/scene.py:fetch_rows)."""
    verts = _f32(verts, (3, 3), "verts")
    normals = _f32(normals, (3,), "normals")
    obj_ids = np.ascontiguousarray(obj_ids, np.int32)
    T = verts.shape[0]
    if normals.shape[0] != T or obj_ids.shape != (T,):
        raise ValueError(f"fetch_rows: {T} triangles, {normals.shape[0]} "
                         f"normals, obj_ids {obj_ids.shape}")
    out = np.empty((T, 16), np.float32)
    build().lib.rr_fetch_rows(_ptr(verts), _ptr(normals), _ptr(obj_ids), T,
                              _ptr(out))
    return out


def parse_obj(path):
    """Wavefront OBJ -> (verts (T, 3, 3) f32, obj_ids (T,) i32, names), as
    geom/mesh.py:_load_obj reads it (names empty without o/g statements).
    Raises FileNotFoundError for a missing file and ValueError for a
    malformed statement, an index out of range or a file without faces."""
    lib = build().lib
    pathb = os.fsencode(path)
    counts = np.zeros(4, np.int64)     # triangles, objects, names bytes, line
    rc = lib.rr_obj_count(pathb, *(_ptr(counts[i:]) for i in range(4)))
    if rc == 1:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such OBJ file: {path}")
        raise OSError(f"cannot read OBJ file: {path}")
    if rc == 2:
        where = f"line {counts[3]}" if counts[3] else "a face index"
        raise ValueError(f"malformed OBJ file {path}: {where}")
    T, n_objects, names_len = (int(x) for x in counts[:3])
    if T == 0:
        raise ValueError(f"OBJ file without faces: {path}")
    verts = np.empty((T, 3, 3), np.float32)
    obj_ids = np.empty(T, np.int32)
    names = ctypes.create_string_buffer(max(names_len, 1))
    rc = lib.rr_obj_parse(pathb, _ptr(verts), _ptr(obj_ids),
                          ctypes.addressof(names), T, names_len)
    if rc != 0:
        raise OSError(f"OBJ file changed while it was read: {path}")
    text = names.raw[:names_len].decode(errors="replace")
    return verts, obj_ids, text.split("\n")[:n_objects]
