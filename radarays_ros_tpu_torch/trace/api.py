"""Tracing front-end: one call, several engines (counterpart of
radarays_ros_tpu/trace/api.py).

Nearest-hit contract of rmagine's OnDn simulators (RadarCPU.cpp:222-236):
for each ray, whether it hit, the distance, the normal oriented against
the ray and the object id of the nearest triangle.

Engines:
  * "brute"  — Moller-Trumbore over all triangles (trace/intersect.py), the
               correctness oracle;
  * "sweep"  — the ranked chunk sweep with early termination in plain torch
               (the plain versions of the kernels in trace/cuda_trace.py);
  * "kernel" — the same algorithm through the kernel wrappers: the CUDA
               kernels on CUDA tensors, their plain versions on CPU tensors;
  * "mxu"    — every ray against every triangle as dense f32 matmuls in
               plane form (trace/planes.py): no culling, the baseline for
               tiny scenes;
  * "auto"   — "kernel" for CUDA tensors, "sweep" for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID

ENGINES = ("auto", "brute", "sweep", "kernel", "mxu")


class TraceResult(NamedTuple):
    hit: torch.Tensor      # (...,) bool
    t: torch.Tensor        # (...,) float32 hit distance (inf on miss)
    normal: torch.Tensor   # (..., 3) float32 unit normal, against the ray
    obj_id: torch.Tensor   # (...,) int32 object id (INVALID on miss)
    # per-hit value of the scene's per-triangle aux column (the baked
    # material map, geom/scene.py:bake_tri_aux); 0.0 on miss. Only the
    # sweep engines fetch it (trace(with_aux=True)).
    aux: Optional[torch.Tensor] = None


def combine_trace_shards(res: TraceResult, group) -> TraceResult:
    """Merge the trace results of the ranks of `group`, each of which traced
    the same rays against its shard of a chunk-sharded scene
    (geom/scene.py:shard_scene_host) — the reference's trace/api.py:
    combine_trace_shards over torch.distributed.

    The nearest hit of a ray is the least of the ranks' winners: one MIN
    all-reduce of t (+inf on a miss), a second MIN of the rank among the
    exact-t winners (ties go to the lowest rank of `group`), then one SUM
    all-reduce of the winner's normal, obj_id and aux as int32 bit
    patterns, every other rank's rows zero: integer sums with zero are
    exact, -0.0 included. The result carries no gradient."""
    import torch.distributed as dist

    rank = dist.get_rank(group)
    t = torch.where(res.hit, res.t, torch.inf).detach().contiguous()
    t_g = t.clone()
    dist.all_reduce(t_g, op=dist.ReduceOp.MIN, group=group)
    win = res.hit & (t == t_g)
    w_rank = torch.where(win, rank, 2**30).to(torch.int32)
    dist.all_reduce(w_rank, op=dist.ReduceOp.MIN, group=group)
    mine = win & (w_rank == rank)
    cols = [res.normal.detach().contiguous().view(torch.int32),
            res.obj_id.to(torch.int32)[..., None]]
    if res.aux is not None:
        cols.append(res.aux.detach().contiguous().view(torch.int32)[..., None])
    rows = torch.where(mine[..., None], torch.cat(cols, dim=-1), 0)
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    hit = torch.isfinite(t_g)
    return TraceResult(
        hit=hit, t=t_g,
        normal=rows[..., :3].contiguous().view(torch.float32),
        obj_id=torch.where(hit, rows[..., 3], int(INVALID_OBJ_ID)),
        aux=None if res.aux is None
        else rows[..., 4].contiguous().view(torch.float32))


def resolve_engine(engine: str, device) -> str:
    """Resolve "auto" for the device the rays live on."""
    if engine == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "sweep"
    if engine not in ENGINES:
        raise ValueError(f"unknown trace engine {engine!r}")
    return engine


def trace(scene, origs, dirs, engine: str = "auto", t_budget=None,
          with_aux: bool = False, **kwargs) -> TraceResult:
    """Trace rays against a SceneTensors; origs/dirs shaped (..., 3).

    t_budget: optional per-ray maximum hit distance shaped like
    origs[..., 0]. A hit beyond a ray's budget is a MISS for every engine
    alike; the sweep engines also use the budget to prune chunks, which is
    exact (a within-budget hit lies in a chunk entered within budget).
    kwargs go to the engine: t_min, t_max; for the sweep engines
    ray_block, prep_group, sort_rays, two_phase_cap and k_chunks
    (trace/cuda_trace.py:trace_sweep); for "mxu" ray_block and tri_chunk.
    """
    batch_shape = origs.shape[:-1]
    o = origs.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    b = None if t_budget is None else \
        torch.as_tensor(t_budget, dtype=torch.float32).reshape(-1)
    engine = resolve_engine(engine, o.device)
    if engine == "brute":
        from radarays_ros_tpu_torch.trace.intersect import trace_brute
        res = trace_brute(scene, o, d, **kwargs)
    elif engine == "mxu":
        from radarays_ros_tpu_torch.trace.planes import trace_planes
        res = trace_planes(scene, o, d, **kwargs)
    else:
        from radarays_ros_tpu_torch.trace.cuda_trace import trace_sweep
        res = trace_sweep(scene, o, d, t_budget=b, with_aux=with_aux,
                          kernels=engine == "kernel", **kwargs)
    if b is not None:
        # uniform budget contract: the nearest hit beyond budget is a miss
        # (then every farther hit is too, so masking the nearest is exact)
        ok = res.hit & (res.t <= b)
        res = TraceResult(
            hit=ok,
            t=torch.where(ok, res.t, torch.inf),
            normal=torch.where(ok[:, None], res.normal, 0.0),
            obj_id=torch.where(ok, res.obj_id, int(INVALID_OBJ_ID)),
            aux=None if res.aux is None else torch.where(ok, res.aux, 0.0),
        )
    return TraceResult(
        hit=res.hit.reshape(batch_shape),
        t=res.t.reshape(batch_shape),
        normal=res.normal.reshape(batch_shape + (3,)),
        obj_id=res.obj_id.reshape(batch_shape),
        aux=None if res.aux is None else res.aux.reshape(batch_shape),
    )
