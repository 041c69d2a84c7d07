"""Brute-force Moller-Trumbore tracer — the correctness oracle (counterpart of
radarays_ros_tpu/trace/intersect.py). Every ray against every triangle,
blocked over rays to bound memory."""

from __future__ import annotations

import torch

from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID
from radarays_ros_tpu_torch.trace.api import TraceResult

_DET_EPS = 1e-12


def _mt_block(o, d, v0, e1, e2, t_min, t_max):
    """o, d (R, 3); v0, e1, e2 (T, 3) -> (t, hit) shaped (R, T)."""
    db = d[:, None, :].expand(-1, e2.shape[0], -1)
    pvec = torch.linalg.cross(db, e2[None].expand_as(db))
    det = torch.sum(e1[None] * pvec, dim=-1)
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
    v = torch.sum(d[:, None, :] * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None] * qvec, dim=-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) \
        & (t <= t_max)
    return t, hit


def trace_brute(scene, origs, dirs, t_min: float = 0.0, t_max: float = 1000.0
                ) -> TraceResult:
    """Nearest-hit trace of (R, 3) rays against the whole triangle soup
    (t_max 1000 = the reference's OnDn range, radar_algorithms.cpp:157)."""
    verts = scene.verts
    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0
    e2 = verts[:, 2] - v0
    T = verts.shape[0]
    R = origs.shape[0]
    rb = max(1, (1 << 24) // T)     # rays per block: ~16M (ray, tri) pairs
    best_t = torch.empty(R, dtype=torch.float32, device=origs.device)
    best = torch.empty(R, dtype=torch.int64, device=origs.device)
    for s in range(0, R, rb):
        t, hit = _mt_block(origs[s:s + rb], dirs[s:s + rb], v0, e1, e2,
                           t_min, t_max)
        tm = torch.where(hit, t, torch.inf)
        bt = tm.amin(dim=-1)
        # lowest index among exact ties, as the reference's argmin
        best[s:s + rb] = torch.where(
            tm == bt[:, None], torch.arange(T, device=origs.device)[None],
            T).amin(-1)
        best_t[s:s + rb] = bt
    hit = torch.isfinite(best_t)
    n = scene.normals[best]
    n = torch.where(torch.sum(n * dirs, dim=-1, keepdim=True) > 0.0, -n, n)
    return TraceResult(
        hit=hit,
        t=torch.where(hit, best_t, torch.inf),
        normal=torch.where(hit[:, None], n, 0.0),
        obj_id=torch.where(hit, scene.obj_ids[best], int(INVALID_OBJ_ID)),
    )
