"""Ranked chunk sweep with early termination: the CUDA kernels K1-K3, their
plain torch versions, and the glue around them (counterpart of
radarays_ros_tpu/trace/pallas_trace.py).

Per block of `ray_block` rays:
  1. culling prep — slab-test the rays against the (super)chunk AABBs:
     each chunk's block entry (min over lanes of the entry distance, +inf
     when no lane can reach it within its budget) and each lane's t_last
     (the largest entry among the chunks it reaches). Scenes with at least
     256 supergroups take the hierarchical prep: a coarse per-(ray tile,
     32-chunk group) bitmap (K3, `coarse_words`) gates the per-chunk tests
     (K2, `prep_hier`). Smaller scenes take the flat prep (K4,
     `prep_flat`): every lane against every box.
  2. rank the block's chunks by entry (stable sort); nvisit = the number of
     finite entries.
  3. sweep (K1, `sweep`) — visit chunks front to back, keep each lane's
     nearest hit; each aligned group of 32 lanes stops once the next entry
     exceeds max over its lanes of min(best_t, t_last); fetch the winner
     records.
  4. the winner's distance is refined by Moller-Trumbore (trace/planes.py).

Gradients: the winner search is discrete, so steps 1-3 run on detached
rays and budgets; d(t)/d(origin, direction) flows only through the
Moller-Trumbore refinement of step 4 (the reference's stop_gradient at
pallas_trace.py:1131-1142, 1187-1189).

Around the blocks (trace_sweep, the reference's trace_pallas_v3 options,
pallas_trace.py:1144-1189): `sort_rays` orders the rays by a spatial key
before blocking, so that incoherent ray sets form coherent blocks;
`two_phase_cap` traces every ray with its budget capped first and traces
again, compacted to the front and at full budget, the lanes the cap left
unresolved; `k_chunks` caps each block's sweep (the reference's culled
engine's cap, no longer exact). The sorts are stable torch.sort, the
permutations index_select gathers; no host sync learns a count.

Every kernel wrapper runs the plain version for CPU tensors and launches
the kernel for CUDA tensors (or raises); it counts its launches in
`<wrapper>.launches`. The plain versions compute the same function in the
same operation order, each product and sum rounded separately, so on the
card the two agree bit for bit.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from radarays_ros_tpu_torch.geom.scene import cross3 as _cross
from radarays_ros_tpu_torch.trace.planes import _DIR_EPS, _finalize_packed

_INSIDE_EPS = float(np.float32(1e-5))   # meters; edge planes are unit-length
_SG = 32          # chunks per coarse group of the hierarchical prep
_ELEMS = 1 << 25  # element budget of one plain-version temporary


def _check_index_width(n_triangles: int, n_rays: int) -> None:
    """The kernels take triangle indices and counts as 32-bit ints (row
    offsets are 64-bit): refuse a scene or a ray set they cannot index."""
    if max(n_triangles, n_rays) >= 2**31:
        raise ValueError(f"{n_triangles} triangles, {n_rays} rays: the trace "
                         "kernels index both with 32-bit ints (at most "
                         f"{2**31 - 1})")


def _auto_prep_group(n_chunks: int) -> int:
    """Chunks per culling supergroup: 1 up to 12288 chunks (~3M triangles
    at chunk size 256), then 2/4/8 (the reference's _auto_prep_group;
    powers of two <= 8 divide the chunk count, which the scene build pads
    to a multiple of 8)."""
    g = 1
    while g < 8 and -(-n_chunks // g) > 12288:
        g *= 2
    return g


# ------------------------------------------------------------ slab tests

def _slab_keep(lo, hi, o, idv, cap):
    """The reference's _slab_keep (pallas_trace.py:466-485), broadcasting
    boxes lo/hi (..., 3) against rays o/idv (..., 3) and cap (...).
    Returns (keep, tn0); tn0 = max(t_near, 0) with -0 mapped to +0 (as the
    kernels do, so entries compare bitwise)."""
    t_near = t_far = None
    for k in range(3):
        t0 = (lo[..., k] - o[..., k]) * idv[..., k]
        t1 = (hi[..., k] - o[..., k]) * idv[..., k]
        tn_k = torch.minimum(t0, t1)
        tf_k = torch.maximum(t0, t1)
        t_near = tn_k if t_near is None else torch.maximum(t_near, tn_k)
        t_far = tf_k if t_far is None else torch.minimum(t_far, tf_k)
    tn0 = torch.where(t_near > 0.0, t_near, 0.0)
    keep = (t_far >= tn0) & (t_near <= cap) & (cap > 0.0)
    return keep, tn0


# ------------------------------------------------------------ K3: coarse

def _coarse_words_plain(slo, shi, o, idv, bud, t_max: float, rbt: int):
    """Plain K3: (G, n_super/32) int32 words; bit s of word w says whether
    any lane of ray tile g keeps supergroup 32w + s."""
    G = o.shape[0] // rbt
    S = slo.shape[0]
    cap = torch.clamp_max(bud, t_max).view(G, rbt, 1)
    flags = torch.empty(G, S, dtype=torch.bool, device=o.device)
    step = max(1, _ELEMS // (rbt * S))
    for g0 in range(0, G, step):
        sl = slice(g0 * rbt, min(G, g0 + step) * rbt)
        keep, _ = _slab_keep(slo[None, None], shi[None, None],
                             o[sl].view(-1, rbt, 1, 3),
                             idv[sl].view(-1, rbt, 1, 3), cap[g0:g0 + step])
        flags[g0:g0 + step] = keep.any(dim=1)
    bits = flags.view(G, S // 32, 32).to(torch.int64)
    w = (bits << torch.arange(32, device=o.device)).sum(-1)
    # bit 31 is the int32 sign bit
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def coarse_words(slo, shi, o, idv, bud, t_max: float, rbt: int):
    """K3 wrapper (see module doc): plain version on CPU tensors, the CUDA
    kernel rr_coarse_words on CUDA tensors."""
    if o.device.type == "cpu":
        return _coarse_words_plain(slo, shi, o, idv, bud, t_max, rbt)
    from radarays_ros_tpu_torch import cuda_build

    cuda_build.check_tensors("coarse_words", slo, shi, o, idv, bud,
                             dtypes=(torch.float32,) * 5)
    G = o.shape[0] // rbt
    S = slo.shape[0]
    if S % 32 or rbt % 32 or o.shape[0] % rbt:
        raise ValueError(f"coarse_words: {S} supergroups (a multiple of 32), "
                         f"{o.shape[0]} rays for tile {rbt} (a multiple of "
                         "32)")
    # rr_coarse_words zeroes the words, then ORs every warp's bits in
    words = torch.empty(G, S // 32, dtype=torch.int32, device=o.device)
    lib = cuda_build.build().lib
    cuda_build.check(lib.rr_coarse_words(
        slo.data_ptr(), shi.data_ptr(), S, o.data_ptr(), idv.data_ptr(),
        bud.data_ptr(), G, rbt, float(t_max), words.data_ptr(),
        cuda_build.stream_ptr(o)), "rr_coarse_words")
    coarse_words.launches += 1
    return words


coarse_words.launches = 0


# ------------------------------------------------------ K2 and K4: prep

def _prep_plain(lo, hi, o, idv, bud, t_max: float, RB: int, rbt: int,
                words=None):
    """Plain culling prep: entry (B, Cp) + t_last (B*RB,).

    With `words` it is the plain K2 — the per-chunk tests count only under
    the tile's set coarse bits; without, the flat prep (the reference's
    K4). The coarse test is conservative (a chunk box lies inside its
    group box, and the slab test is monotone), so both give the same
    values; the mask keeps the plain K2 faithful to its kernel."""
    Rp = o.shape[0]
    Cp = lo.shape[0]
    G = Rp // rbt
    B = Rp // RB
    cap = torch.clamp_max(bud, t_max).view(G, rbt, 1)
    entry_t = torch.empty(G, Cp, dtype=torch.float32, device=o.device)
    t_last = torch.empty(G, rbt, dtype=torch.float32, device=o.device)
    if words is not None:
        shifts = torch.arange(32, device=o.device, dtype=torch.int32)
        bits = ((words[:, :, None] >> shifts) & 1).bool()     # (G, nw, 32)
        mask = bits.view(G, -1).repeat_interleave(_SG, dim=1)[:, :Cp]
    step = max(1, _ELEMS // (rbt * Cp))
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        sl = slice(g0 * rbt, g1 * rbt)
        keep, tn0 = _slab_keep(lo[None, None], hi[None, None],
                               o[sl].view(-1, rbt, 1, 3),
                               idv[sl].view(-1, rbt, 1, 3), cap[g0:g1])
        if words is not None:
            keep = keep & mask[g0:g1, None, :]
        entry_t[g0:g1] = torch.where(keep, tn0, torch.inf).amin(dim=1)
        t_last[g0:g1] = torch.where(keep, tn0, -torch.inf).amax(dim=2)
    entry = entry_t.view(B, RB // rbt, Cp).amin(dim=1)
    return entry, t_last.view(-1)


def prep_hier(words, lo, hi, o, idv, bud, t_max: float, RB: int, rbt: int):
    """K2 wrapper: plain version on CPU tensors, the CUDA kernel
    rr_prep_hier on CUDA tensors."""
    if o.device.type == "cpu":
        return _prep_plain(lo, hi, o, idv, bud, t_max, RB, rbt, words=words)
    from radarays_ros_tpu_torch import cuda_build

    cuda_build.check_tensors("prep_hier", lo, hi, o, idv, bud,
                             dtypes=(torch.float32,) * 5)
    cuda_build.check_tensors("prep_hier", words, dtypes=(torch.int32,))
    Rp = o.shape[0]
    Cp = lo.shape[0]
    G = Rp // rbt
    if Rp % RB or RB % rbt or rbt % 128 or rbt > 1024 or Cp % _SG \
            or words.shape[0] != G or words.shape[1] * 32 * _SG < Cp:
        raise ValueError("prep_hier: inconsistent shapes "
                         f"(rays {Rp}, block {RB}, tile {rbt}, "
                         f"words {tuple(words.shape)}, chunks {Cp})")
    # both outputs are folded into by atomics: entries by min, t_last by max
    entry = torch.full((Rp // RB, Cp), torch.inf, dtype=torch.float32,
                       device=o.device)
    t_last = torch.full((Rp,), -torch.inf, dtype=torch.float32,
                        device=o.device)
    lib = cuda_build.build().lib
    cuda_build.check(lib.rr_prep_hier(
        words.data_ptr(), words.shape[1], lo.data_ptr(), hi.data_ptr(), Cp,
        o.data_ptr(), idv.data_ptr(), bud.data_ptr(), G, rbt, RB // rbt,
        float(t_max), entry.data_ptr(), t_last.data_ptr(),
        cuda_build.stream_ptr(o)), "rr_prep_hier")
    prep_hier.launches += 1
    return entry, t_last


prep_hier.launches = 0


_FLAT_TILE = 256   # lanes a K4 CTA takes in one pass: 128 threads x 2
                   # lanes (prep.cu RR_FLAT_THREADS, RR_FLAT_LANES)
_FLAT_CLUSTER = 8  # CTAs of a ray block's cluster at most (portable size)


def _flat_tile(RB: int) -> int:
    """K4's tile: RB / I lanes for the fewest CTAs I (at most 8, each a
    whole number of warps) whose tiles take one pass; a block of more than
    8 such tiles gets 8 wider tiles, each taken in several passes."""
    fits = [i for i in range(1, _FLAT_CLUSTER + 1) if RB % (32 * i) == 0]
    if not fits:
        raise ValueError(f"prep_flat: ray block {RB} is not a multiple of 32")
    return RB // next((i for i in fits if RB // i <= _FLAT_TILE), fits[-1])


def prep_flat(lo, hi, o, idv, bud, t_max: float, RB: int):
    """K4 wrapper: the plain flat prep on CPU tensors, the CUDA kernel
    rr_prep_flat on CUDA tensors: one cluster of RB / _flat_tile(RB) CTAs
    per ray block, writing every entry itself (no fill)."""
    rbt = _flat_tile(RB)
    if o.device.type == "cpu":
        return _prep_plain(lo, hi, o, idv, bud, t_max, RB, rbt)
    from radarays_ros_tpu_torch import cuda_build

    cuda_build.check_tensors("prep_flat", lo, hi, o, idv, bud,
                             dtypes=(torch.float32,) * 5)
    Rp = o.shape[0]
    Cp = lo.shape[0]
    if Rp % RB or not 1 <= Cp <= 1024 or hi.shape != lo.shape \
            or bud.shape != (Rp,):
        raise ValueError(f"prep_flat: inconsistent shapes (rays {Rp}, block "
                         f"{RB}, boxes {Cp}, at most 1024)")
    entry = torch.empty((Rp // RB, Cp), dtype=torch.float32, device=o.device)
    t_last = torch.empty(Rp, dtype=torch.float32, device=o.device)
    lib = cuda_build.build().lib
    cuda_build.check(lib.rr_prep_flat(
        lo.data_ptr(), hi.data_ptr(), Cp, o.data_ptr(), idv.data_ptr(),
        bud.data_ptr(), Rp // rbt, rbt, RB // rbt, float(t_max),
        entry.data_ptr(), t_last.data_ptr(), cuda_build.stream_ptr(o)),
        "rr_prep_flat")
    prep_flat.launches += 1
    return entry, t_last


prep_flat.launches = 0


def _coarse_boxes(lo, hi):
    """Boxes of the coarse groups (32 consecutive chunks each), padded with
    far boxes to a multiple of 32 groups (pallas_trace.py:605-612)."""
    S = lo.shape[0] // _SG
    slo = lo.view(S, _SG, 3).amin(dim=1)
    shi = hi.view(S, _SG, 3).amax(dim=1)
    Sp = -(-S // 32) * 32
    far = torch.full((Sp - S, 3), 1e9, dtype=torch.float32, device=lo.device)
    return (torch.cat([slo, far]).contiguous(),
            torch.cat([shi, far + 1.0]).contiguous())


def _run_prep(lo, hi, o, idv, bud, *, t_max: float, RB: int, kernels: bool):
    """entry (B, Cp) + t_last (B*RB,) for padded supergroup boxes lo/hi
    (Cp, 3) — the reference's _run_prep_kernel (pallas_trace.py:641)."""
    Cp = lo.shape[0]
    if not (Cp % _SG == 0 and Cp // _SG >= 8):
        if kernels:
            return prep_flat(lo, hi, o, idv, bud, t_max, RB)
        return _prep_plain(lo, hi, o, idv, bud, t_max, RB, _flat_tile(RB))
    rbt = next(r for r in (1024, 512, 256, 128) if RB % r == 0)
    slo, shi = _coarse_boxes(lo, hi)
    if kernels:
        words = coarse_words(slo, shi, o, idv, bud, t_max, rbt)
        return prep_hier(words, lo, hi, o, idv, bud, t_max, RB, rbt)
    words = _coarse_words_plain(slo, shi, o, idv, bud, t_max, rbt)
    return _prep_plain(lo, hi, o, idv, bud, t_max, RB, rbt, words=words)


# ------------------------------------------------------------ K1: sweep

def _chunk_t(o, d, w, cf, t_min: float):
    """Masked plane-form distances of rays (..., RB, 1, 3) against
    triangles cf (..., 1, tc, 22): (..., RB, tc), inf where no hit."""
    def q(i):
        return cf[..., i]

    def dot3(i, v):
        return (q(i) * v[..., 0] + q(i + 1) * v[..., 1]) + q(i + 2) * v[..., 2]

    so = dot3(0, o) + q(3)
    sd = dot3(0, d)
    pmin = None
    for e in range(3):
        nk = ((dot3(13 + 3 * e, d) + q(4 + 3 * e) * w[..., 0])
              + q(5 + 3 * e) * w[..., 1]) + q(6 + 3 * e) * w[..., 2]
        p = nk * sd
        pmin = p if pmin is None else torch.minimum(pmin, p)
    t = (-so) / sd
    meps = _INSIDE_EPS * (sd * sd)
    hit = (pmin + meps >= 0.0) & (t >= t_min)
    return torch.where(hit, t, torch.inf)


def _sweep_plain(nvisit, order, entry, o, d, t_last, coef, fetch, *,
                 tc: int, group: int, t_min: float, with_visits: bool = False):
    """Plain K1: every aligned group of 32 consecutive lanes of a ray block
    walks its block's ranked list on its own; all groups advance in
    lock-step over visit rank, as (groups, 32, tc) tensors per step, until
    every group is done.

    A group starts only if its first ranked entry is <= max over its lanes
    of t_last, and stops once the next entry exceeds max over its lanes of
    min(best_t, t_last) — the reference's per-lane exactness argument
    (pallas_trace.py:112-120) at the kernel's warp granularity.

    o x d (`_cross`) is rounded per product and difference, as sweep.cu.

    nvisit (B,) i32; order/entry (B, ce) ranked supergroups and entries
    (+inf after the last); o, d (B*RB, 3); t_last (B*RB,). Returns best_t
    (B*RB,), best_idx (B*RB,) i32 (-1 on miss) and rows (B*RB, 16); with
    `with_visits` also the supergroups visited per 32-lane group (B,
    RB/32) i32."""
    B = nvisit.shape[0]
    G = o.shape[0] // (B * 32)                  # 32-lane groups per block
    dev = o.device
    ob = o.view(B, G, 32, 1, 3)
    db = d.view(B, G, 32, 1, 3)
    wb = _cross(o, d).view(B, G, 32, 1, 3)
    tl = t_last.view(B, G, 32)
    best_t = torch.full((B, G, 32), torch.inf, device=dev)
    best_i = torch.zeros((B, G, 32), dtype=torch.int64, device=dev)
    coef_g = coef.view(-1, group, tc, coef.shape[1])
    rows_ix = torch.arange(tc, device=dev)
    active = (nvisit > 0)[:, None] & ~(entry[:, :1] > tl.amax(dim=2))
    visits = torch.zeros((B, G), dtype=torch.int32, device=dev)
    k = 0
    while bool(active.any()):
        ab, gb = torch.nonzero(active, as_tuple=True)
        c = order[ab, k].long()
        bt = best_t[ab, gb]
        bi = best_i[ab, gb]
        for g in range(group):
            tm = _chunk_t(ob[ab, gb], db[ab, gb], wb[ab, gb],
                          coef_g[c, g][:, None], t_min)       # (n, 32, tc)
            local_t = tm.amin(dim=-1)
            local_i = torch.where(tm == local_t[..., None], rows_ix,
                                  tc).amin(dim=-1)
            better = local_t < bt
            bt = torch.where(better, local_t, bt)
            bi = torch.where(better, (c[:, None] * group + g) * tc + local_i,
                             bi)
        best_t[ab, gb] = bt
        best_i[ab, gb] = bi
        visits[ab, gb] += 1
        worst = torch.minimum(bt, tl[ab, gb]).amax(dim=1)
        done = entry[ab, k + 1] > worst
        active[ab, gb] = ~done & (k + 1 < nvisit[ab])
        k += 1
    best_t = best_t.view(-1)
    live = best_t < torch.inf
    best_i = torch.where(live, best_i.view(-1), -1)
    rows = torch.where(live[:, None], fetch[best_i.clamp_min(0)], 0.0)
    if with_visits:
        return best_t, best_i.to(torch.int32), rows, visits
    return best_t, best_i.to(torch.int32), rows


class ChunkSizeRefused(ValueError):
    """A chunk size K1 cannot stage on this card: raised before launch."""


def sweep_smem_bytes(tc: int) -> int:
    """K1's dynamic shared memory a CTA: two stages of tc x 22 floats and
    their barriers (sweep.cu:rr_sweep)."""
    return 2 * tc * 22 * 4 + 16


@functools.lru_cache(maxsize=None)
def sweep_smem_limit(index) -> int:
    """The most dynamic shared memory a CTA may ask for on card `index`."""
    return torch.cuda.get_device_properties(
        index or 0).shared_memory_per_block_optin


def sweep(nvisit, order, entry, o, d, t_last, coef, fetch, *, tc: int,
          group: int, t_min: float):
    """K1 wrapper: plain version on CPU tensors, the CUDA kernel rr_sweep
    on CUDA tensors. Same arguments and results as _sweep_plain."""
    if o.device.type == "cpu":
        return _sweep_plain(nvisit, order, entry, o, d, t_last, coef, fetch,
                            tc=tc, group=group, t_min=t_min)
    from radarays_ros_tpu_torch import cuda_build

    cuda_build.check_tensors("sweep", nvisit, order,
                             dtypes=(torch.int32,) * 2)
    cuda_build.check_tensors("sweep", entry, o, d, t_last, coef, fetch,
                             dtypes=(torch.float32,) * 6)
    B, ce = order.shape
    Rp = o.shape[0]
    if Rp % B or (Rp // B) % 128 or entry.shape != (B, ce) \
            or coef.shape[1] != 22 or fetch.shape[1] != 16 \
            or coef.shape[0] % (tc * group) or tc % 2:
        raise ValueError("sweep: inconsistent shapes (the kernel takes ray "
                         "blocks of a multiple of 128 and an even chunk "
                         "size)")
    if coef.data_ptr() % 16:
        raise ValueError("sweep: coef must be 16-byte aligned (its chunks "
                         "are staged by TMA bulk copies)")
    smem, limit = sweep_smem_bytes(tc), sweep_smem_limit(o.device.index)
    if smem > limit:
        raise ChunkSizeRefused(f"sweep: chunk size {tc} stages {smem} bytes "
                               f"of shared memory a CTA; the card gives at "
                               f"most {limit}")
    best_t = torch.empty(Rp, dtype=torch.float32, device=o.device)
    best_i = torch.empty(Rp, dtype=torch.int32, device=o.device)
    rows = torch.empty(Rp, 16, dtype=torch.float32, device=o.device)
    lib = cuda_build.build().lib
    cuda_build.check(lib.rr_sweep(
        nvisit.data_ptr(), order.data_ptr(), entry.data_ptr(), ce,
        o.data_ptr(), d.data_ptr(), t_last.data_ptr(), coef.data_ptr(),
        fetch.data_ptr(), B, Rp // B, tc, group, float(t_min), _INSIDE_EPS,
        best_t.data_ptr(), best_i.data_ptr(), rows.data_ptr(),
        cuda_build.stream_ptr(o)), "rr_sweep")
    sweep.launches += 1
    return best_t, best_i, rows


sweep.launches = 0


# ------------------------------------------------------------ the trace

def _rank(entry):
    """Per-block front-to-back ranking (a stable sort of the entries):
    nvisit (B,) = finite entries, order (B, C2+1) i32 and the ranked entries
    (B, C2+1) with a +inf sentinel after the last (pallas_trace.py:859-872)."""
    B = entry.shape[0]
    entry_ranked, order = torch.sort(entry, dim=1, stable=True)
    nvisit = torch.isfinite(entry_ranked).sum(dim=1).to(torch.int32)
    inf = torch.full((B, 1), torch.inf, device=entry.device)
    zero = torch.zeros((B, 1), dtype=torch.int32, device=entry.device)
    return (nvisit, torch.cat([order.to(torch.int32), zero], 1).contiguous(),
            torch.cat([entry_ranked, inf], 1).contiguous())


def _prep_inputs(scene, origs, dirs, budget, *, ray_block: int, group: int):
    """The reference's glue before the prep (pallas_trace.py:809-850): pad
    the rays to whole blocks (padding lanes get budget 0: no entries,
    t_last = -inf), supergroup AABBs, 1/d with _DIR_EPS, and the padded
    box table (far boxes). Returns (o, d, inv_d, bud, lo, hi, C2)."""
    C = scene.n_chunks
    if C % group:
        raise ValueError(f"prep_group {group} must divide the {C} chunks")
    R = origs.shape[0]
    _check_index_width(scene.n_triangles, R + ray_block)
    dev = origs.device
    pad = (-R) % ray_block
    o = torch.cat([origs, torch.zeros(pad, 3, device=dev)]).contiguous()
    d = torch.cat([dirs, torch.ones(pad, 3, device=dev)]).contiguous()
    bud = torch.cat([budget, torch.zeros(pad, device=dev)])
    bud = torch.where(torch.arange(o.shape[0], device=dev) < R, bud, 0.0)
    eps = torch.where(d >= 0, _DIR_EPS, -_DIR_EPS)
    inv_d = (1.0 / torch.where(torch.abs(d) > _DIR_EPS, d, eps)).contiguous()

    C2 = C // group
    sg_lo = scene.chunk_lo.view(C2, group, 3).amin(dim=1)
    sg_hi = scene.chunk_hi.view(C2, group, 3).amax(dim=1)
    ct = 512 if C2 >= 8 * _SG else min(512, max(8, C2))
    Cp2 = -(-C2 // ct) * ct
    far = torch.full((Cp2 - C2, 3), 1e9, dtype=torch.float32, device=dev)
    return (o, d, inv_d, bud.contiguous(), torch.cat([sg_lo, far]).contiguous(),
            torch.cat([sg_hi, far + 1.0]).contiguous(), C2)


def sweep_winners(scene, origs, dirs, budget, *, t_min: float, t_max: float,
                  ray_block: int, group: int, kernels: bool,
                  k_chunks: int = 0):
    """Nearest plane-form hit per ray: (best_t (R,) masked to <= t_max,
    best_idx (R,), rows (R, 16)) — the reference's _trace_pallas_v3_impl
    glue (pallas_trace.py:798-927) around the prep and the sweep. With
    k_chunks > 0 each block's ranked list is cut after its first k_chunks
    entries (K1 visits at most nvisit)."""
    R = origs.shape[0]
    o, d, inv_d, bud, lo, hi, C2 = _prep_inputs(
        scene, origs, dirs, budget, ray_block=ray_block, group=group)
    entry, t_last = _run_prep(lo, hi, o, inv_d, bud, t_max=t_max,
                              RB=ray_block, kernels=kernels)
    nvisit, order, entry_ranked = _rank(entry[:, :C2])
    if k_chunks:
        nvisit = torch.clamp_max(nvisit, k_chunks)
    run = sweep if kernels else _sweep_plain
    best_t, best_i, rows = run(
        nvisit, order, entry_ranked, o, d, t_last, scene.coef, scene.fetch,
        tc=scene.chunk_size, group=group, t_min=t_min)
    # the sweep keeps no t_max test per element: if the nearest hit is
    # beyond t_max every hit is, so masking the winner once is exact
    bt = best_t[:R]
    return torch.where(bt <= t_max, bt, torch.inf), best_i[:R], rows[:R]


def _ray_sort_key(origs, dirs):
    """Spatial sort key of rays (the reference's _ray_sort_key,
    pallas_trace.py:952-971), int32 and bit-equal to it: a Morton code of
    6 bits an axis over the origins' bounding box, in the reference's f32
    order ((o - lo) / ext * 63, clipped, truncated), then the direction
    octant as the low 3 bits. Rays that start near each other come
    together whatever their direction."""
    lo = origs.amin(dim=0)
    ext = torch.clamp_min(origs.amax(dim=0) - lo, 1e-6)
    q = torch.clamp((origs - lo) / ext * 63.0, 0.0, 63.0).to(torch.int32)
    code = torch.zeros(origs.shape[0], dtype=torch.int32, device=origs.device)
    for b in range(6):
        for ax in range(3):
            code = code | (((q[:, ax] >> b) & 1) << (3 * b + ax))
    pos = (dirs > 0).to(torch.int32)
    octant = pos[:, 0] * 4 + pos[:, 1] * 2 + pos[:, 2]
    return (code << 3) | octant


def _permuted(run, key, o, d, bud):
    """run(o, d, bud) -> (best_t, rows) on the rays in the order of a
    stable sort by key, returned in the rays' own order (a stable sort
    keeps the order within each key, so the blocks hold the reference's
    rays)."""
    perm = torch.sort(key, stable=True).indices
    t_s, rows_s = run(o.index_select(0, perm), d.index_select(0, perm),
                      bud.index_select(0, perm))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return t_s.index_select(0, inv), rows_s.index_select(0, inv)


def _two_phase(run, cap: float, o, d, bud):
    """The reference's two-phase requeue (pallas_trace.py:1160-1179),
    exact: phase 1 traces with budgets capped at `cap`; a lane is resolved
    when its winner lies within its capped budget (a nearer triangle would
    lie in a chunk entered within it); the others with a budget beyond the
    cap are traced again at full budget, compacted to the front by a stable
    sort, while the rest get budget 0 (their blocks visit nothing)."""
    b1 = torch.clamp_max(bud, cap)
    t1, rows1 = run(o, d, b1)
    resolved = torch.isfinite(t1) & (t1 <= b1)
    live = ~resolved & (bud > cap)
    t2, rows2 = _permuted(run, resolved.to(torch.int32), o, d,
                          torch.where(live, bud, 0.0))
    return (torch.where(resolved, t1, t2),
            torch.where(resolved[:, None], rows1, rows2))


def trace_sweep(scene, origs, dirs, t_min: float = 0.0, t_max: float = 1000.0,
                ray_block: int = 2048, t_budget=None, prep_group: int = 0,
                with_aux: bool = False, kernels: bool = True,
                sort_rays: bool = False, two_phase_cap=None, k_chunks=None):
    """Ranked chunk sweep trace of (R, 3) rays (engines "sweep" with
    kernels=False, "kernel" with kernels=True; trace/api.py).

    sort_rays: trace the rays in the order of _ray_sort_key and restore
    theirs after; for incoherent ray sets (radar fans are coherent as they
    are). Distances and hits are unchanged; obj_id may differ on exact-
    distance ties, whose winner is the first in visit order.
    two_phase_cap: the two-phase requeue at this cap [m] (_two_phase).
    k_chunks: the reference culled engine's cap — at most k_chunks ranked
    entries a block (None or 0: no cap). Below the block's entry count it
    is no longer exact and warns, as the reference does."""
    if ray_block % 128:
        raise ValueError(f"ray_block must be a multiple of 128, got "
                         f"{ray_block}")
    group = prep_group or _auto_prep_group(scene.n_chunks)
    C2 = scene.n_chunks // group
    K = min(k_chunks or C2, C2)
    if K < C2:
        warnings.warn(
            f"trace_sweep: k_chunks={K} caps each block's sweep below the "
            f"scene's {C2} ranked entries — the trace is NO LONGER "
            "GUARANTEED EXACT (a hit is missed whenever more than k_chunks "
            "entries rank closer than it). This opts out of the engines-"
            "match-brute contract; use k_chunks=None unless bounding the "
            "worst-case sweep is worth approximate results.", stacklevel=3)
    o = origs.detach().to(torch.float32)
    d = dirs.detach().to(torch.float32)
    budget = (torch.full(origs.shape[:1], t_max, device=origs.device)
              if t_budget is None else t_budget.detach().to(torch.float32))

    def run(o_r, d_r, b_r):
        best_t, _, rows = sweep_winners(
            scene, o_r, d_r, b_r, t_min=t_min, t_max=t_max,
            ray_block=ray_block, group=group, kernels=kernels,
            k_chunks=K if K < C2 else 0)
        return best_t, rows

    def phased(o_r, d_r, b_r):
        if two_phase_cap is None:
            return run(o_r, d_r, b_r)
        return _two_phase(run, float(two_phase_cap), o_r, d_r, b_r)

    if sort_rays:
        best_t, rows = _permuted(phased, _ray_sort_key(o, d), o, d, budget)
    else:
        best_t, rows = phased(o, d, budget)
    return _finalize_packed(origs, dirs, best_t, rows, with_aux=with_aux)
