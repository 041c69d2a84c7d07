"""Plane-form tracing: the dense "mxu" engine and the winner finalization
with the Moller-Trumbore refinement (counterpart of
radarays_ros_tpu/trace/planes.py).

The "mxu" engine recasts intersection as two dense matmuls per tile of
rays against a chunk of triangles (the plane tables of geom/scene.py:
plane_tables, four rows a triangle [support, edge0, edge1, edge2]):

    SO = [o | 1] @ planes_o^T        (R, 4) x (4, 4Tc)  -> (R, 4Tc)
    SD =  d      @ planes_d^T        (R, 3) x (3, 4Tc)  -> (R, 4Tc)

For triangle j, t = -SO[:, 4j] / SD[:, 4j], inside iff SO[:, 4j+k] +
t SD[:, 4j+k] >= -1e-5 for the three edge planes. Every triangle is
tested, chunk after chunk, keeping each ray's nearest hit (strict <: ties
go to the earlier chunk, then the lower index). The products run through
torch.matmul in true f32: TF32, like the TPU's bf16 input truncation
(planes.py:113-118 of the reference), quantizes t enough to reorder nearby
surfaces, so the engine refuses to run on the card with TF32 on.

The plane-form t of a winner is ill-conditioned at grazing incidence
(small n.d); one Moller-Trumbore evaluation against the winning triangle
restores parity with the brute oracle, and is where gradients w.r.t. the
ray origins and directions flow (the winner itself is discrete).
"""

from __future__ import annotations

import torch

from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID, plane_tables
from radarays_ros_tpu_torch.trace.api import TraceResult

_DIR_EPS = 1e-12
_INSIDE_EPS = 1e-5      # meters; edge planes are unit-length
# elements of one (rays, 4 x tri_chunk) product of the dense engine: 256 MB
# of f32, about 1 GB at the tile's peak with its temporaries
_MXU_ELEMS = 1 << 26


def _check_f32_matmul(device) -> None:
    """The dense engine's products must be true f32 on the card."""
    if torch.device(device).type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the mxu engine needs f32 matmuls: TF32 is on "
            f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"precision={torch.get_float32_matmul_precision()!r})")


def _plane_hits(o_aug, d, po_T, pd_T, t_min: float, t_max: float):
    """A ray tile against a chunk of triangles by two matmuls.

    o_aug (R, 4); d (R, 3); po_T (4, 4Tc); pd_T (3, 4Tc). Returns (t, hit)
    shaped (R, Tc)."""
    so = torch.matmul(o_aug, po_T)
    sd = torch.matmul(d, pd_T)
    R = so.shape[0]
    so = so.view(R, -1, 4)
    sd = sd.view(R, -1, 4)
    s0o, s0d = so[..., 0], sd[..., 0]
    denom_ok = torch.abs(s0d) > _DIR_EPS
    t = -s0o / torch.where(denom_ok, s0d, 1.0)
    p_edges = so[..., 1:] + t[..., None] * sd[..., 1:]
    inside = torch.all(p_edges >= -_INSIDE_EPS, dim=-1)
    hit = denom_ok & inside & (t >= t_min) & (t <= t_max)
    return t, hit


def _pad_rays(origs, dirs, block: int):
    R = origs.shape[0]
    pad = (-R) % block
    o = torch.cat([origs, origs.new_zeros(pad, 3)])
    d = torch.cat([dirs, dirs.new_ones(pad, 3)])
    return o, d, R


def _refine_t(origs, dirs, v0, e1, e2, best_t):
    """Moller-Trumbore against only the winning triangle (v0, e1, e2)."""
    pvec = torch.linalg.cross(dirs, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    tvec = origs - v0
    qvec = torch.linalg.cross(tvec, e1)
    det_ok = torch.abs(det) > _DIR_EPS
    t_mt = torch.sum(e2 * qvec, dim=-1) / torch.where(det_ok, det, 1.0)
    return torch.where(det_ok & torch.isfinite(best_t), t_mt, best_t)


def _finalize(scene, origs, dirs, best_idx, best_t) -> TraceResult:
    verts = scene.verts[best_idx]                       # (R, 3, 3)
    v0 = verts[:, 0]
    best_t = _refine_t(origs, dirs, v0, verts[:, 1] - v0, verts[:, 2] - v0,
                       best_t)
    hit = torch.isfinite(best_t)
    n = scene.normals[best_idx]
    n = torch.where(torch.sum(n * dirs, dim=-1, keepdim=True) > 0.0, -n, n)
    return TraceResult(
        hit=hit,
        t=torch.where(hit, best_t, torch.inf),
        normal=torch.where(hit[:, None], n, 0.0),
        obj_id=torch.where(hit, scene.obj_ids[best_idx], int(INVALID_OBJ_ID)),
    )


def trace_planes(scene, origs, dirs, t_min: float = 0.0, t_max: float = 1000.0,
                 ray_block: int = 2048, tri_chunk: int = 2048) -> TraceResult:
    """The "mxu" engine: every ray against every triangle chunk, (R, 3)
    rays. Uses the scene's plane tables (geom/scene.py:with_planes), or
    builds them for this call. Rays go in tiles of whole ray blocks, as
    many as keep one product within _MXU_ELEMS elements; the tiling does
    not change the result."""
    _check_f32_matmul(origs.device)
    if scene.planes_o is None:
        planes_o, planes_d = plane_tables(scene.verts)
    else:
        planes_o, planes_d = scene.planes_o, scene.planes_d
    T = scene.n_triangles
    tc = min(tri_chunk, T)
    n_tc = -(-T // tc)
    pad_t = n_tc * tc - T
    if pad_t:
        # planes that are never hit (support normal 0: |sd| = 0)
        planes_o = torch.cat([planes_o, planes_o.new_zeros(4 * pad_t, 4)])
        planes_d = torch.cat([planes_d, planes_d.new_zeros(4 * pad_t, 3)])
    po_T = planes_o.view(n_tc, 4 * tc, 4).transpose(1, 2)
    pd_T = planes_d.view(n_tc, 4 * tc, 3).transpose(1, 2)

    # the winner search is discrete: no graph through the tiles
    o, d, R = _pad_rays(origs.detach(), dirs.detach(), ray_block)
    tile = ray_block * max(1, _MXU_ELEMS // (ray_block * 4 * tc))
    dev = o.device
    rows_ix = torch.arange(tc, device=dev)
    best_t = torch.empty(o.shape[0], device=dev)
    best_idx = torch.empty(o.shape[0], dtype=torch.int64, device=dev)
    for r0 in range(0, o.shape[0], tile):
        ob, db = o[r0:r0 + tile], d[r0:r0 + tile]
        o_aug = torch.cat([ob, ob.new_ones(ob.shape[0], 1)], dim=1)
        bt = torch.full((ob.shape[0],), torch.inf, device=dev)
        bi = torch.zeros(ob.shape[0], dtype=torch.int64, device=dev)
        for k in range(n_tc):
            t, hit = _plane_hits(o_aug, db, po_T[k], pd_T[k], t_min, t_max)
            tm = torch.where(hit, t, torch.inf)
            local_t = tm.amin(dim=-1)
            # the first index among exact ties, as the reference's argmin
            local = torch.where(tm == local_t[:, None], rows_ix,
                                tc).amin(dim=-1)
            better = local_t < bt
            bt = torch.where(better, local_t, bt)
            bi = torch.where(better, k * tc + local, bi)
        best_t[r0:r0 + tile] = bt
        best_idx[r0:r0 + tile] = bi
    return _finalize(scene, origs, dirs, best_idx[:R], best_t[:R])


def _finalize_packed(origs, dirs, best_t, rows, with_aux: bool = False
                     ) -> TraceResult:
    """_finalize for the sweep engines, which fetch the winner's record:
    best_t (R,) nearest plane-form distance (inf on miss); rows (R, 16)
    the winner records [v0, e1, e2, normal, obj bits, aux, 0, 0]
    (geom/scene.py:fetch_rows)."""
    t = _refine_t(origs, dirs, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
                  best_t)
    hit = torch.isfinite(best_t)
    n = rows[:, 9:12]
    n = torch.where(torch.sum(n * dirs, dim=-1, keepdim=True) > 0.0, -n, n)
    obj = rows[:, 12].contiguous().view(torch.int32)
    return TraceResult(
        hit=hit,
        t=torch.where(hit, t, torch.inf),
        normal=torch.where(hit[:, None], n, 0.0),
        obj_id=torch.where(hit, obj, int(INVALID_OBJ_ID)),
        aux=torch.where(hit, rows[:, 13], 0.0) if with_aux else None,
    )
