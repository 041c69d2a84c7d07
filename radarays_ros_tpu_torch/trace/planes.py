"""Winner finalization with the Moller-Trumbore refinement (counterpart of
radarays_ros_tpu/trace/planes.py:_finalize_packed).

The plane-form t of the sweep is ill-conditioned at grazing incidence
(small n.d); one Moller-Trumbore evaluation against the winning triangle
restores parity with the brute oracle, and is where gradients w.r.t. the
ray origins and directions flow (the winner itself is discrete).
"""

from __future__ import annotations

import torch

from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID
from radarays_ros_tpu_torch.trace.api import TraceResult

_DIR_EPS = 1e-12


def _finalize_packed(origs, dirs, best_t, rows, with_aux: bool = False
                     ) -> TraceResult:
    """best_t (R,) nearest plane-form distance (inf on miss); rows (R, 16)
    the winner records [v0, e1, e2, normal, obj bits, aux, 0, 0]
    (geom/scene.py:fetch_rows), fetched by the sweep."""
    v0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    pvec = torch.linalg.cross(dirs, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    tvec = origs - v0
    qvec = torch.linalg.cross(tvec, e1)
    det_ok = torch.abs(det) > _DIR_EPS
    t_mt = torch.sum(e2 * qvec, dim=-1) / torch.where(det_ok, det, 1.0)
    ok = det_ok & torch.isfinite(best_t)
    t = torch.where(ok, t_mt, best_t)

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
