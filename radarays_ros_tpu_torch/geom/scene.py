"""Scene representation: the host build + the torch tensors the tracers use.

Counterpart of radarays_ros_tpu/geom/scene.py. The host side — padding with
far triangles, the SAH-scored leaf ordering, the plane equations and chunk
AABBs — is a NumPy copy of the reference's builders (that package cannot be
imported without jax), held bit-identical by tests/test_torch_geom.py. By
default the C++ library of native/builder.py runs each step instead, bit-
equal to the NumPy functions here (tests/test_torch_native.py), which stay
as its plain version: RADARAYS_NO_NATIVE=1 selects them.

The device side differs on purpose: the reference stores bf16 split-exact
tables (sweep_table_t, tri_table_t) because the TPU's matrix unit truncates
f32 inputs to bf16. The CUDA sweep kernel evaluates the same coefficients
with f32 scalar arithmetic, so `SceneTensors` keeps them as plain f32:

  * coef  (T, 22): per triangle [n (3), c, A_0..A_2 (9), B_0..B_2 (9)] with
    the support plane (n, c) and, per edge k, A_k = m_k x n and
    B_k = c_k n - c m_k (geom/scene.py:231-237 of the reference), so that
        so = n.o + c,  sd = n.d,  N_k = B_k.d + A_k.(o x d)
    and the inside test is min_k(N_k sd) + 1e-5 sd^2 >= 0 at t = -so/sd;
  * fetch (T, 16): the winner record [v0, e1, e2, normal, obj_id bits,
    aux, 0, 0]; column 12 holds the int32 object id bit pattern, column 13
    the per-triangle aux value (the baked material map, `bake_tri_aux`).

Triangles are chunk-major after the ordering, so chunk c is rows
c*chunk_size .. (c+1)*chunk_size - 1 of every per-triangle tensor.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

_log = logging.getLogger(__name__)

# Sentinel for "no hit" object ids; the reference flags invalid hits with
# obj_id > 10000 (radar_algorithms.cpp:29, RadarCPU.cpp:252).
INVALID_OBJ_ID = np.int32(2**31 - 1)

COEF_WIDTH = 22
FETCH_WIDTH = 16


def _triangle_planes(verts: np.ndarray):
    """Support plane + three unit edge planes per triangle (copy of the
    reference's geom/scene.py:_triangle_planes, same op order)."""
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = n / np.maximum(norm, 1e-30)

    edges = [(v0, v1), (v1, v2), (v2, v0)]
    plane_normals = [n_unit]
    plane_offsets = [-np.sum(n_unit * v0, axis=-1)]
    for a, b in edges:
        m = np.cross(n_unit, b - a)
        mlen = np.linalg.norm(m, axis=-1, keepdims=True)
        m = m / np.maximum(mlen, 1e-30)
        plane_normals.append(m)
        plane_offsets.append(-np.sum(m * a, axis=-1))

    N = np.stack(plane_normals, axis=1)          # (T, 4, 3)
    O = np.stack(plane_offsets, axis=1)          # (T, 4)
    planes_o = np.concatenate(
        [N.reshape(-1, 3), O.reshape(-1, 1)], axis=-1
    ).astype(np.float32)                          # (4T, 4)
    return n_unit.astype(np.float32), planes_o


def _median_split_order(centers: np.ndarray, chunk_size: int) -> np.ndarray:
    """Top-down longest-axis median split into leaves of exactly chunk_size
    (copy of the reference's geom/scene.py:_median_split_order), the
    ordering of RADARAYS_ORDER_VARIANT=median."""
    n = centers.shape[0]
    assert n % chunk_size == 0
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n)]
    while stack:
        s = stack.pop()
        if s.shape[0] <= chunk_size:
            out[pos:pos + s.shape[0]] = s
            pos += s.shape[0]
            continue
        c = centers[s]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        half = ((s.shape[0] // 2) // chunk_size) * chunk_size
        part = np.argpartition(c[:, ax], half)
        stack.append(s[part[half:]])
        stack.append(s[part[:half]])
    return out


def _median_split_order_sah(centers: np.ndarray, tri_lo: np.ndarray,
                            tri_hi: np.ndarray, chunk_size: int) -> np.ndarray:
    """SAH-scored top-down split into leaves of exactly chunk_size triangles
    (copy of the reference's geom/scene.py:_median_split_order_sah).

    At every node all 3 axes x all chunk_size-multiple split positions are
    scored by SA(left)*n_left + SA(right)*n_right, with child boxes from
    prefix/suffix min-max scans of the per-triangle AABBs; children inherit
    each axis' presorted order by a stable mask filter.
    """
    n = centers.shape[0]
    assert n % chunk_size == 0
    out = np.empty(n, np.int64)
    pos = 0
    member = np.zeros(n, bool)
    stack = [tuple(np.argsort(centers[:, ax], kind="stable")
                   for ax in range(3))]
    while stack:
        axs = stack.pop()
        m = axs[0].shape[0]
        if m <= chunk_size:
            out[pos:pos + m] = axs[0]
            pos += m
            continue
        n_pos = m // chunk_size - 1
        hs = np.arange(1, n_pos + 1) * chunk_size
        best = None
        for ax in range(3):
            lo_o = tri_lo[axs[ax]]
            hi_o = tri_hi[axs[ax]]
            pl_lo = np.minimum.accumulate(lo_o, axis=0)
            pl_hi = np.maximum.accumulate(hi_o, axis=0)
            sf_lo = np.minimum.accumulate(lo_o[::-1], axis=0)[::-1]
            sf_hi = np.maximum.accumulate(hi_o[::-1], axis=0)[::-1]
            dl = pl_hi[hs - 1] - pl_lo[hs - 1]
            dr = sf_hi[hs] - sf_lo[hs]
            sa_l = dl[:, 0] * dl[:, 1] + dl[:, 1] * dl[:, 2] \
                + dl[:, 2] * dl[:, 0]
            sa_r = dr[:, 0] * dr[:, 1] + dr[:, 1] * dr[:, 2] \
                + dr[:, 2] * dr[:, 0]
            cost = sa_l * hs + sa_r * (m - hs)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (float(cost[j]), ax, int(hs[j]))
        _, bax, h = best
        left_ids = axs[bax][:h]
        member[left_ids] = True
        left = tuple(a[member[a]] for a in axs)
        right = tuple(a[~member[a]] for a in axs)
        member[left_ids] = False
        stack.append(right)
        stack.append(left)
    return out


def padded_chunks(n_triangles: int, chunk_size: int) -> int:
    """The chunks a scene of n_triangles is built into: whole chunks, their
    count rounded up to a multiple of 8 so that every supergroup size in
    {1, 2, 4, 8} divides it."""
    whole = -(-n_triangles // chunk_size)
    return -(-whole // 8) * 8


def ordering_variant() -> str:
    """The chunk ordering, from RADARAYS_ORDER_VARIANT (the reference's
    variable): "sah" (default) or "median"."""
    variant = os.environ.get("RADARAYS_ORDER_VARIANT", "sah")
    if variant not in ("sah", "median"):
        raise ValueError(f"RADARAYS_ORDER_VARIANT={variant!r}: expected "
                         "'sah' or 'median'")
    return variant


def cache_flavor(variant: Optional[str] = None) -> str:
    """The scene-cache key's builder flavor for the ordering variant and
    the active builder: the SAH build's bytes are the same from the library
    and from NumPy, so both share one key, with the builder's table
    version; the median split's are not (centroid ties), so its flavor
    names the builder."""
    from radarays_ros_tpu_torch.geom.cache import BUILDER_FLAVOR
    from radarays_ros_tpu_torch.native import builder as nb

    variant = variant or ordering_variant()
    version = nb.builder_version() if nb.enabled() else nb.BUILDER_VERSION
    if variant == "sah":
        return f"{BUILDER_FLAVOR}-sah-b{version}"
    return (f"{BUILDER_FLAVOR}-median-native-b{version}" if nb.enabled()
            else f"{BUILDER_FLAVOR}-median-numpy")


def edge_coefficients(planes_o: np.ndarray) -> np.ndarray:
    """(4T, 4) plane rows -> (T, 22) f32 [n, c, A_k, B_k] (module doc).

    A and B are computed in f32 exactly as the reference's
    _sweep_tables does before it splits them into bf16 parts."""
    T = planes_o.shape[0] // 4
    po = planes_o.reshape(T, 4, 4)
    n = po[:, 0, :3]
    c_t = po[:, 0, 3:4]
    m = po[:, 1:4, :3]
    ck = po[:, 1:4, 3]
    A = np.cross(m, n[:, None, :])
    B = ck[..., None] * n[:, None, :] - c_t[..., None] * m
    return np.ascontiguousarray(np.concatenate(
        [n, c_t, A.reshape(T, 9), B.reshape(T, 9)], axis=1), np.float32)


def fetch_rows(verts: np.ndarray, normals: np.ndarray,
               obj_ids: np.ndarray) -> np.ndarray:
    """(T, 16) winner records [v0, e1, e2, normal, obj bits, aux=0, 0, 0]."""
    T = verts.shape[0]
    v0 = verts[:, 0]
    rows = np.zeros((T, FETCH_WIDTH), np.float32)
    rows[:, 0:3] = v0
    rows[:, 3:6] = verts[:, 1] - v0
    rows[:, 6:9] = verts[:, 2] - v0
    rows[:, 9:12] = normals
    rows[:, 12] = np.ascontiguousarray(obj_ids, np.int32).view(np.float32)
    return rows


class SceneHost(NamedTuple):
    """The finished host build (NumPy), chunk-major."""

    verts: np.ndarray         # (T, 3, 3) f32, padded + SAH-ordered
    obj_ids: np.ndarray       # (T,) int32
    normals: np.ndarray       # (T, 3) unit geometric normals
    planes_o: np.ndarray      # (4T, 4) [support, edge0, edge1, edge2] rows
    chunk_lo: np.ndarray      # (C, 3) chunk AABB minima
    chunk_hi: np.ndarray      # (C, 3)
    chunk_size: int


class SceneTensors(NamedTuple):
    """Device scene consumed by the tracers (all torch tensors on one
    device, except the static chunk_size). The plane tables of the "mxu"
    engine (112 bytes a triangle) are made only for scenes that engine
    traces (`with_planes`)."""

    verts: torch.Tensor       # (T, 3, 3) f32 — brute oracle
    obj_ids: torch.Tensor     # (T,) int32
    normals: torch.Tensor     # (T, 3) f32
    coef: torch.Tensor        # (T, 22) f32 intersection coefficients
    fetch: torch.Tensor       # (T, 16) f32 winner records
    chunk_lo: torch.Tensor    # (C, 3) f32
    chunk_hi: torch.Tensor    # (C, 3) f32
    chunk_size: int
    planes_o: Optional[torch.Tensor] = None   # (4T, 4) f32, or None
    planes_d: Optional[torch.Tensor] = None   # (4T, 3) f32, or None

    @property
    def n_triangles(self) -> int:
        return self.verts.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.chunk_lo.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coef.device


def bake_tri_aux(st: SceneTensors, tri_aux) -> SceneTensors:
    """Return `st` with a per-triangle f32 value in the fetch rows' aux
    column (the reference's geom/scene.py:bake_tri_aux). The radar pipeline
    bakes the object->material map here at material-load time
    (sim/radar.py:_bake_aux), so the trace returns each hit's material."""
    row = torch.as_tensor(tri_aux, dtype=torch.float32, device=st.device)
    if row.shape != (st.n_triangles,):
        raise ValueError(f"tri_aux must be shaped (T,) = ({st.n_triangles},),"
                         f" got {tuple(row.shape)}")
    fetch = st.fetch.clone()
    fetch[:, 13] = row
    return st._replace(fetch=fetch)


def cross3(a, b):
    """a x b over the last axis, each product and difference rounded
    separately in np.cross's order."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def plane_tables(verts: torch.Tensor):
    """`_triangle_planes` in torch on the verts' device, in NumPy's
    operation order (bit-identical to the host build's planes_o): returns
    planes_o (4T, 4) [support, edge0, edge1, edge2] and planes_d (4T, 3),
    their normals."""
    def dot(a, b):
        # np.sum over an axis of 3 adds in order to its identity +0, which
        # turns a sum of -0 terms into +0
        return ((0.0 + a[..., 0] * b[..., 0]) + a[..., 1] * b[..., 1]) \
            + a[..., 2] * b[..., 2]

    def unit(v):
        # the f32 root correctly rounded (torch's f32 sqrt on the CPU is
        # not always; the f64 root of an f32 rounds to the same f32)
        norm = torch.sqrt(dot(v, v).double()).float()
        return v / torch.clamp_min(norm, 1e-30)[..., None]

    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    n_unit = unit(cross3(v1 - v0, v2 - v0))
    normals, offsets = [n_unit], [-dot(n_unit, v0)]
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        m = unit(cross3(n_unit, b - a))
        normals.append(m)
        offsets.append(-dot(m, a))
    planes_d = torch.stack(normals, dim=1).reshape(-1, 3)
    offsets = torch.stack(offsets, dim=1).reshape(-1, 1)
    return torch.cat([planes_d, offsets], dim=1), planes_d


def with_planes(st: SceneTensors) -> SceneTensors:
    """`st` with the "mxu" engine's plane tables, built on its device."""
    if st.planes_o is not None:
        return st
    planes_o, planes_d = plane_tables(st.verts)
    return st._replace(planes_o=planes_o, planes_d=planes_d)


@dataclasses.dataclass
class Scene:
    """Host-side scene: triangle soup + per-triangle object ids.

    `object_materials[obj_id]` gives the material id of an object (the
    reference's `object_materials` param, Radar.cpp:220-226).
    """

    verts: np.ndarray                 # (T, 3, 3) float32
    obj_ids: np.ndarray               # (T,) int32
    object_names: Optional[Sequence[str]] = None
    chunk_size: int = 256

    def __post_init__(self):
        self.verts = np.ascontiguousarray(self.verts, dtype=np.float32)
        self.obj_ids = np.ascontiguousarray(self.obj_ids, dtype=np.int32)
        if self.verts.ndim != 3 or self.verts.shape[1:] != (3, 3):
            raise ValueError(f"verts must be (T,3,3), got {self.verts.shape}")
        if self.obj_ids.shape != (self.verts.shape[0],):
            raise ValueError("obj_ids must be (T,)")

    @property
    def n_triangles(self) -> int:
        return self.verts.shape[0]

    @property
    def n_objects(self) -> int:
        return int(self.obj_ids.max()) + 1 if self.n_triangles else 0

    @staticmethod
    def compose(parts: Sequence[np.ndarray],
                names: Optional[Sequence[str]] = None,
                chunk_size: int = 256) -> "Scene":
        """Build a scene from a list of per-object (Ti, 3, 3) vertex arrays."""
        verts = np.concatenate(parts, axis=0).astype(np.float32)
        obj_ids = np.concatenate(
            [np.full((p.shape[0],), i, np.int32) for i, p in enumerate(parts)]
        )
        return Scene(verts, obj_ids, names, chunk_size)

    def host_arrays(self, cache: Optional[bool] = None,
                    stages: Optional[dict] = None) -> SceneHost:
        """Pad, order and precompute planes + chunk AABBs — the host part
        of the reference's Scene.device_arrays (geom/scene.py:559-610),
        without the bf16 kernel tables.

        cache: persist/reuse the finished build on disk, keyed by scene
        content (geom/cache.py). None (default) = on for scenes of at
        least 200k triangles, as the reference's device_arrays; True/False
        force it. RADARAYS_SCENE_CACHE_DISABLE=1 turns it off.
        stages: a dict that receives the build's figures (`_build_host`)
        and, when the build is stored, "store_s"."""
        if self.n_triangles == 0:
            raise ValueError("empty scene")
        if cache is None:
            cache = self.n_triangles >= 200_000
        if os.environ.get("RADARAYS_SCENE_CACHE_DISABLE", "0") == "1":
            cache = False
        if not cache:
            return self._build_host(stages)
        from radarays_ros_tpu_torch.geom import cache as scache

        key = scache.scene_cache_key(self.verts, self.obj_ids,
                                     self.chunk_size)
        hit = scache.load_scene_host(key)
        if hit is not None:
            _log.info("scene build: cache hit (%s, %d triangles)", key[:12],
                      hit.verts.shape[0])
            return hit
        _log.info("scene build: cache miss, building %d triangles",
                  self.n_triangles)
        host = self._build_host(stages)
        t0 = time.perf_counter()
        try:
            scache.store_scene_host(key, host)
        except OSError as e:        # disk full / read-only cache dir
            warnings.warn(f"scene cache write failed ({e}); continuing "
                          "without cache", stacklevel=2)
        if stages is not None:
            stages["store_s"] = time.perf_counter() - t0
        return host

    def _build_host(self, stages: Optional[dict] = None) -> SceneHost:
        """The build, by the C++ library or (RADARAYS_NO_NATIVE=1) NumPy;
        `stages` receives the builder's name and the seconds of the
        ordering ("order_s") and of the planes and chunk AABBs
        ("planes_s")."""
        from radarays_ros_tpu_torch.native import builder as nb

        native = nb.enabled()
        variant = ordering_variant()
        t0 = time.perf_counter()
        verts, obj_ids = self.verts, self.obj_ids
        tc = self.chunk_size
        # pad first (far degenerate triangles cluster into their own
        # leaves)
        T = verts.shape[0]
        C = padded_chunks(T, tc)
        pad = C * tc - T
        if pad:
            far = np.full((pad, 3, 3), 1e8, np.float32)
            far[:, 1, 0] += 1.0   # tiny offsets keep normals finite
            far[:, 2, 1] += 1.0
            verts = np.concatenate([verts, far], axis=0)
            obj_ids = np.concatenate(
                [obj_ids, np.full((pad,), INVALID_OBJ_ID, np.int32)])
        centers = verts.mean(axis=1)
        if variant == "median":
            order = (nb.median_split_order(centers, tc) if native
                     else _median_split_order(centers, tc))
        else:
            order = (nb.sah_split_order if native else
                     _median_split_order_sah)(centers, verts.min(axis=1),
                                              verts.max(axis=1), tc)
        verts = np.ascontiguousarray(verts[order])
        obj_ids = np.ascontiguousarray(obj_ids[order])
        t1 = time.perf_counter()
        if native:
            normals, planes_o = nb.triangle_planes(verts)
            lo, hi = nb.chunk_aabbs(verts, tc)
        else:
            normals, planes_o = _triangle_planes(verts)
            chunks = verts.reshape(C, tc, 3, 3)
            lo, hi = chunks.min(axis=(1, 2)), chunks.max(axis=(1, 2))
        t2 = time.perf_counter()
        _log.info("scene build (%s, %s): ordering %.2f s, planes + AABBs "
                  "%.2f s", "native" if native else "numpy", variant,
                  t1 - t0, t2 - t1)
        if stages is not None:
            stages.update(builder="native" if native else "numpy",
                          variant=variant, order_s=t1 - t0,
                          planes_s=t2 - t1)
        return SceneHost(verts=verts, obj_ids=obj_ids, normals=normals,
                         planes_o=planes_o, chunk_lo=lo, chunk_hi=hi,
                         chunk_size=tc)

    def to_device(self, device, cache: Optional[bool] = None
                  ) -> SceneTensors:
        """Host build (cached as `host_arrays` says) + upload (see
        `scene_tensors`)."""
        return scene_tensors(self.host_arrays(cache=cache), device)


def shard_scene_host(h: SceneHost, n_shards: int) -> list:
    """Split a host build into n chunk-contiguous shards (the reference's
    geom/scene.py:shard_scene_arrays, as a list of SceneHost): shard i holds
    a contiguous run of whole chunks, every per-triangle field cut along
    its chunk-major rows. Each shard holds the same chunk count,
    ceil(C / n) rounded up to a multiple of 8 (so every prep group in
    {1, 2, 4, 8} divides it): the last shards are padded with never-hit
    chunks of far triangles at 1e8 (object INVALID_OBJ_ID) whose boxes lie
    at 1e9. The trace tables (`scene_tensors`) and the baked material map
    (`bake_tri_aux`) are then made per shard from its own fields."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    tc = int(h.chunk_size)
    C = h.chunk_lo.shape[0]
    per = -(-C // n_shards)
    per += (-per) % 8
    pad = per * n_shards - C
    f = {k: np.asarray(v) for k, v in h._asdict().items()
         if k != "chunk_size"}
    if pad:
        pv = np.full((pad * tc, 3, 3), 1e8, np.float32)
        pv[:, 1, 0] += 1.0   # tiny offsets keep normals finite
        pv[:, 2, 1] += 1.0
        pn, ppo = _triangle_planes(pv)
        ext = dict(verts=pv, obj_ids=np.full((pad * tc,), INVALID_OBJ_ID,
                                             np.int32),
                   normals=pn, planes_o=ppo,
                   chunk_lo=np.full((pad, 3), 1e9, np.float32),
                   chunk_hi=np.full((pad, 3), 1e9, np.float32) + 1.0)
        f = {k: np.concatenate([v, ext[k]]) for k, v in f.items()}
    parts = {k: np.split(v, n_shards) for k, v in f.items()}
    return [SceneHost(**{k: p[i] for k, p in parts.items()}, chunk_size=tc)
            for i in range(n_shards)]


def device_tables(h: SceneHost):
    """The f32 device tables of a host build, (coef (T, 22), fetch (T, 16)),
    by the C++ library or (RADARAYS_NO_NATIVE=1) NumPy."""
    from radarays_ros_tpu_torch.native import builder as nb

    if nb.enabled():
        return (nb.edge_coefficients(h.planes_o),
                nb.fetch_rows(h.verts, h.normals, h.obj_ids))
    return (edge_coefficients(h.planes_o),
            fetch_rows(h.verts, h.normals, h.obj_ids))


def scene_tensors(h: SceneHost, device) -> SceneTensors:
    """Upload a finished host build as SceneTensors on `device`."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    coef, fetch = device_tables(h)
    return SceneTensors(
        verts=put(h.verts), obj_ids=put(h.obj_ids), normals=put(h.normals),
        coef=put(coef), fetch=put(fetch),
        chunk_lo=put(h.chunk_lo), chunk_hi=put(h.chunk_hi),
        chunk_size=int(h.chunk_size))
