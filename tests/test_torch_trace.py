"""The port's trace (radarays_ros_tpu_torch.trace) against the JAX package.

The culling prep (coarse words K3, hierarchical prep K2) and the ranked
sweep (K1) run here as their plain torch versions — the kernel wrappers
take them for CPU tensors — and are held against the reference's Pallas
kernels in interpret mode on the same inputs, and against the brute
Moller-Trumbore oracles of both packages under the contract of
tests/test_trace.py:77-83 (hit and obj_id equal, t within 1e-4).

The scene (make_urban_scene(200, 60, seed=3) at chunk size 8) has 304
chunks, at least 8 groups of 32, so both packages take the hierarchical
prep; the same buildings at chunk size 32 have 80 chunks, under 256
supergroups, so both take the flat prep (K4).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radarays_ros_tpu.geom.primitives import make_urban_scene as jx_urban
from radarays_ros_tpu.geom.scene import Scene as JxScene
from radarays_ros_tpu.trace import pallas_trace as JP
from radarays_ros_tpu.trace.api import trace as jx_trace

from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
from radarays_ros_tpu_torch.geom.scene import (INVALID_OBJ_ID, Scene,
                                               padded_chunks)
from radarays_ros_tpu_torch.trace import cuda_trace as CT
from radarays_ros_tpu_torch.trace.api import resolve_engine, trace

torch.set_num_threads(2)

RB = 128


@pytest.fixture(scope="module")
def scenes():
    parts, names = make_urban_scene(n_buildings=200, extent=60.0, seed=3)
    st = Scene.compose(parts, names, chunk_size=8).to_device("cpu")
    jparts, jnames = jx_urban(n_buildings=200, extent=60.0, seed=3)
    sa = JxScene.compose(jparts, jnames, chunk_size=8).device_arrays(
        cache=False)
    assert st.n_chunks == 304 and st.n_chunks >= 8 * CT._SG
    return st, sa


def _fan(n, seed, el_lo=-0.2, el_hi=0.5, budgets=(10.0, 50.0, 1000.0)):
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(el_lo, el_hi, n)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), (n, 3)).copy()
    bud = rng.choice(budgets, n).astype(np.float32)
    return o, d, bud


def _prep_args(st, n=512, seed=0):
    o, d, bud = _fan(n, seed)
    return CT._prep_inputs(st, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(bud), ray_block=RB, group=1)


def test_coarse_words_match_reference(scenes):
    """Plain K3 words equal the reference's _coarse_bitmap (interpret)."""
    st, _ = scenes
    o, d, inv_d, bud, lo, hi, C2 = _prep_args(st)
    Cp = lo.shape[0]
    slo, shi = CT._coarse_boxes(lo, hi)
    rbt = 128
    got = CT.coarse_words(slo, shi, o, inv_d, bud, 1000.0, rbt)
    G = o.shape[0] // rbt
    ref = JP._coarse_bitmap(
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
        jnp.asarray(o.numpy().reshape(G, rbt, 3).transpose(0, 2, 1)),
        jnp.asarray(inv_d.numpy().reshape(G, rbt, 3).transpose(0, 2, 1)),
        jnp.asarray(bud.numpy().reshape(G, 1, rbt)), Cp=Cp, t_max=1000.0,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got != 0).any()


@pytest.mark.parametrize("kernels", [False, True])
def test_hier_prep_matches_reference(scenes, kernels):
    """Plain K2 entry and t_last equal the reference's _run_prep_kernel
    (interpret) bit for bit, via the plain functions and the wrappers."""
    st, _ = scenes
    o, d, inv_d, bud, lo, hi, C2 = _prep_args(st)
    Cp = lo.shape[0]
    B = o.shape[0] // RB
    entry, t_last = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=RB,
                                 kernels=kernels)
    r_entry, r_tlast = JP._run_prep_kernel(
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
        jnp.asarray(o.numpy().reshape(B, RB, 3).transpose(0, 2, 1)),
        jnp.asarray(inv_d.numpy().reshape(B, RB, 3).transpose(0, 2, 1)),
        jnp.asarray(bud.numpy().reshape(B, 1, RB)), Cp=Cp, RB=RB,
        n_blocks=B, t_max=1000.0, interpret=True)
    np.testing.assert_array_equal(entry.numpy(), np.asarray(r_entry))
    np.testing.assert_array_equal(t_last.numpy(),
                                  np.asarray(r_tlast).reshape(-1))
    assert np.isfinite(entry.numpy()).any()


@pytest.mark.parametrize("rb", [128, 768, 2048])
@pytest.mark.parametrize("kernels", [False, True])
def test_flat_prep_matches_reference(kernels, rb):
    """Plain K4 (the flat prep, via _run_prep and via the wrapper) equals
    the reference's _run_prep_kernel flat branch (interpret) bit for bit on
    a scene under 256 supergroups, at the ray blocks whose clusters on the
    card hold 1, 3 and 8 CTAs (three blocks, the last one partly padding)."""
    parts, names = make_urban_scene(n_buildings=200, extent=60.0, seed=3)
    st = Scene.compose(parts, names, chunk_size=32).to_device("cpu")
    o, d, bud = _fan(2 * rb + 77, seed=7)
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(
        st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(bud),
        ray_block=rb, group=1)
    Cp = lo.shape[0]
    assert C2 == st.n_chunks == 80 and Cp < 8 * CT._SG
    assert rb // CT._flat_tile(rb) == {128: 1, 768: 3, 2048: 8}[rb]
    B = o.shape[0] // rb
    CT.prep_flat.launches = 0
    entry, t_last = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                                 kernels=kernels)
    assert CT.prep_flat.launches == 0      # CPU tensors: plain version
    r_entry, r_tlast = JP._run_prep_kernel(
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
        jnp.asarray(o.numpy().reshape(B, rb, 3).transpose(0, 2, 1)),
        jnp.asarray(inv_d.numpy().reshape(B, rb, 3).transpose(0, 2, 1)),
        jnp.asarray(bud.numpy().reshape(B, 1, rb)), Cp=Cp, RB=rb,
        n_blocks=B, t_max=1000.0, interpret=True)
    np.testing.assert_array_equal(entry.numpy(), np.asarray(r_entry))
    np.testing.assert_array_equal(t_last.numpy(),
                                  np.asarray(r_tlast).reshape(-1))
    assert np.isfinite(entry.numpy()).any() and np.isinf(
        entry.numpy()).any()
    w_entry, w_tlast = CT.prep_flat(lo, hi, o, inv_d, bud, 1000.0, rb)
    assert torch.equal(w_entry, entry) and torch.equal(w_tlast, t_last)


def test_winner_search_is_detached_and_gradient_is_refinement(scenes,
                                                              monkeypatch):
    """Gradients stop before the winner search (the reference's
    stop_gradient, pallas_trace.py:1187-1189): best_t out of the sweep
    carries no autograd graph, and dt/d(dirs) is the Moller-Trumbore
    refinement's against the winning triangle."""
    st, _ = scenes
    o, d, bud = _fan(256, seed=8)
    seen = {}
    finalize = CT._finalize_packed

    def spy(origs, dirs, best_t, rows, **kw):
        seen.update(best_t=best_t, rows=rows)
        return finalize(origs, dirs, best_t, rows, **kw)

    monkeypatch.setattr(CT, "_finalize_packed", spy)
    o_t = torch.from_numpy(o).requires_grad_(True)
    d_t = torch.from_numpy(d).requires_grad_(True)
    b_t = torch.from_numpy(bud).requires_grad_(True)
    res = CT.trace_sweep(st, o_t, d_t, t_budget=b_t * 1.0, ray_block=RB,
                         kernels=False)
    assert seen["best_t"].grad_fn is None
    assert not seen["best_t"].requires_grad
    hit = res.hit
    assert hit.float().mean() > 0.2
    torch.where(hit, res.t, 0.0).sum().backward()
    # the refinement by hand: t = (e2 . (o - v0) x e1) / (e1 . d x e2)
    rows = seen["rows"]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    d_r = d_t.detach().clone().requires_grad_(True)
    t_mt = (torch.sum(e2 * torch.linalg.cross(o_t.detach() - v0, e1), -1)
            / torch.sum(e1 * torch.linalg.cross(d_r, e2), -1))
    torch.where(hit, t_mt, 0.0).sum().backward()
    h = hit.numpy()
    assert np.isfinite(d_t.grad.numpy()).all()
    assert not d_t.grad.numpy()[~h].any()
    np.testing.assert_allclose(d_t.grad.numpy()[h], d_r.grad.numpy()[h],
                               rtol=1e-6, atol=1e-6)
    assert np.abs(d_t.grad.numpy()[h]).max() > 0
    assert b_t.grad is None or not b_t.grad.any()


def test_flat_prep_equals_hier_prep(scenes):
    """The flat prep (plain K4, small scenes) gives the hierarchical prep's
    values: the coarse gate is conservative."""
    st, _ = scenes
    o, d, inv_d, bud, lo, hi, C2 = _prep_args(st, seed=5)
    e_h, t_h = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=RB,
                            kernels=False)
    e_f, t_f = CT._prep_plain(lo, hi, o, inv_d, bud, 1000.0, RB, 128)
    np.testing.assert_array_equal(e_h.numpy(), e_f.numpy())
    np.testing.assert_array_equal(t_h.numpy(), t_f.numpy())


def _assert_contract(ref, got):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(hit, np.asarray(got.hit))
    np.testing.assert_allclose(np.asarray(ref.t)[hit], np.asarray(got.t)[hit],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(ref.obj_id),
                                  np.asarray(got.obj_id))
    np.testing.assert_allclose(np.asarray(ref.normal), np.asarray(got.normal),
                               atol=1e-4)


@pytest.mark.parametrize("engine", ["sweep", "kernel"])
def test_sweep_matches_pallas3_and_brute(scenes, engine):
    """The port's sweep engines against the reference's pallas3 (interpret)
    and against both brute oracles, with budgets and escaping rays."""
    st, sa = scenes
    o, d, bud = _fan(512, seed=1)
    got = trace(st, torch.from_numpy(o), torch.from_numpy(d), engine=engine,
                t_budget=torch.from_numpy(bud), ray_block=RB)
    ref = jx_trace(sa, jnp.asarray(o), jnp.asarray(d), engine="pallas3",
                   t_budget=jnp.asarray(bud), ray_block=RB)
    assert 0.2 < np.asarray(ref.hit).mean() < 0.95
    _assert_contract(ref, got)
    brute = trace(st, torch.from_numpy(o), torch.from_numpy(d),
                  engine="brute", t_budget=torch.from_numpy(bud))
    _assert_contract(brute, got)


def test_brute_matches_reference_brute(scenes):
    st, sa = scenes
    o, d, _ = _fan(256, seed=2)
    got = trace(st, torch.from_numpy(o), torch.from_numpy(d), engine="brute")
    ref = jx_trace(sa, jnp.asarray(o), jnp.asarray(d), engine="brute")
    _assert_contract(ref, got)


def test_kernel_wrappers_equal_plain_bitwise_on_cpu(scenes):
    """On CPU tensors the "kernel" engine runs the plain versions: the
    winners, distances and fetched rows are bit-identical to "sweep"."""
    st, _ = scenes
    o, d, bud = _fan(384, seed=3)
    args = (st, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(bud))
    a = CT.sweep_winners(*args, t_min=0.0, t_max=1000.0, ray_block=RB,
                         group=1, kernels=True)
    b = CT.sweep_winners(*args, t_min=0.0, t_max=1000.0, ray_block=RB,
                         group=1, kernels=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("group", [1, 2, 4])
def test_per_ray_budget_contract(scenes, group):
    """trace(t_budget=b) equals the unbudgeted trace masked to misses where
    t > b, for every supergroup size (the sweep also prunes by budget)."""
    st, _ = scenes
    o, d, bud = _fan(300, seed=4, el_lo=-0.1, el_hi=0.4,
                     budgets=(5.0, 20.0, 75.0, 1000.0))
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    full = trace(st, o_t, d_t, engine="sweep", ray_block=RB,
                 prep_group=group)
    got = trace(st, o_t, d_t, engine="sweep", ray_block=RB,
                prep_group=group, t_budget=torch.from_numpy(bud))
    exp_hit = full.hit.numpy() & (full.t.numpy() <= bud)
    np.testing.assert_array_equal(got.hit.numpy(), exp_hit)
    np.testing.assert_allclose(got.t.numpy()[exp_hit],
                               full.t.numpy()[exp_hit], rtol=1e-6)
    assert np.all(np.isinf(got.t.numpy()[~exp_hit]))
    assert np.all(got.obj_id.numpy()[~exp_hit] == INVALID_OBJ_ID)


def test_auto_engine_and_aux_fetch(scenes):
    """"auto" resolves to "sweep" on CPU; with_aux returns the baked
    per-triangle column of the winner (0 on miss)."""
    from radarays_ros_tpu_torch.geom.scene import bake_tri_aux

    st, _ = scenes
    assert resolve_engine("auto", "cpu") == "sweep"
    assert resolve_engine("auto", "cuda") == "kernel"
    # aux = 1000 + the triangle's object id: the fetched value names the
    # winner's object, which the brute oracle knows independently
    aux = 1000.0 + torch.clamp(st.obj_ids, 0, 10**6).to(torch.float32)
    stb = bake_tri_aux(st, aux)
    o, d, _ = _fan(200, seed=6)
    res = trace(stb, torch.from_numpy(o), torch.from_numpy(d), with_aux=True,
                ray_block=RB)
    brute = trace(st, torch.from_numpy(o), torch.from_numpy(d),
                  engine="brute")
    hit = brute.hit.numpy()
    assert hit.any() and not hit.all()
    assert np.all(res.aux.numpy()[~hit] == 0.0)
    np.testing.assert_array_equal(res.aux.numpy()[hit],
                                  1000.0 + brute.obj_id.numpy()[hit])
    with pytest.raises(ValueError, match="trace engine"):
        trace(st, torch.from_numpy(o), torch.from_numpy(d), engine="pallas3")


def _sweep_block_wide(nvisit, order, entry, o, d, t_last, coef, fetch, *,
                      tc, group, t_min):
    """The plain K1 before per-group termination: every lane of a block
    sweeps until the next entry exceeds max over the BLOCK's lanes of
    min(best_t, t_last). Kept here as the yardstick of the 32-lane rule."""
    B = nvisit.shape[0]
    RB = o.shape[0] // B
    ob, db = o.view(B, RB, 1, 3), d.view(B, RB, 1, 3)
    wb = CT._cross(o, d).view(B, RB, 1, 3)
    tl = t_last.view(B, RB)
    best_t = torch.full((B, RB), torch.inf)
    best_i = torch.zeros((B, RB), dtype=torch.int64)
    coef_g = coef.view(-1, group, tc, coef.shape[1])
    rows_ix = torch.arange(tc)
    active = nvisit > 0
    k = 0
    while bool(active.any()):
        ab = torch.nonzero(active)[:, 0]
        c = order[ab, k].long()
        bt, bi = best_t[ab], best_i[ab]
        for g in range(group):
            tm = CT._chunk_t(ob[ab], db[ab], wb[ab], coef_g[c, g][:, None],
                             t_min)
            local_t = tm.amin(dim=-1)
            local_i = torch.where(tm == local_t[..., None], rows_ix,
                                  tc).amin(dim=-1)
            better = local_t < bt
            bt = torch.where(better, local_t, bt)
            bi = torch.where(better, (c[:, None] * group + g) * tc + local_i,
                             bi)
        best_t[ab], best_i[ab] = bt, bi
        worst = torch.minimum(bt, tl[ab]).amax(dim=1)
        active[ab] = ~(entry[ab, k + 1] > worst) & (k + 1 < nvisit[ab])
        k += 1
    best_t = best_t.view(-1)
    return best_t, torch.where(best_t < torch.inf, best_i.view(-1), -1)


@pytest.mark.parametrize("rb,group", [(128, 1), (128, 2), (2048, 1),
                                      (2048, 2)])
def test_group_termination_equals_block_wide(scenes, rb, group):
    """The plain K1 with termination per aligned group of 32 lanes gives the
    block-wide loop's winners and distances on every lane whose nearest hit
    lies within its budget (the trace's result; beyond-budget hits are
    misses for every engine), on fans with sky rays, escaping rays and
    per-ray budgets including 0; groups of budget-0 lanes visit nothing."""
    st, _ = scenes
    o, d, bud = _fan(4096 + 37, seed=9, el_lo=-0.3, el_hi=1.2,
                     budgets=(0.0, 4.0, 25.0, 1000.0))
    bud[:64] = 0.0                          # two whole groups of dead lanes
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(
        st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(bud),
        ray_block=rb, group=group)
    entry, t_last = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                                 kernels=False)
    nvisit, order, ranked = CT._rank(entry[:, :C2])
    args = (nvisit, order, ranked, o, d, t_last, st.coef, st.fetch)
    gate = (inv_d, bud, st.chunk_lo, st.chunk_hi)
    kw = dict(tc=st.chunk_size, group=group, t_min=0.0)
    bt, bi, rows, visits, _ = CT._sweep_plain(*args, *gate, **kw,
                                              t_max=1000.0, with_visits=True)
    bt_w, bi_w = _sweep_block_wide(*args, **kw)
    cap = torch.clamp_max(bud, 1000.0)
    ok, ok_w = (bt <= cap) & (cap > 0), (bt_w <= cap) & (cap > 0)
    assert torch.equal(ok, ok_w)
    assert 0.1 < float(ok.float().mean()) < 0.9
    assert torch.equal(bt[ok], bt_w[ok]) and torch.equal(bi[ok], bi_w[ok])
    assert torch.equal(rows[ok], st.fetch[bi[ok].long()])
    # the dead groups never start; others stop earlier than their block
    assert (visits.view(-1)[:2] == 0).all()
    assert int(visits.sum()) < int(visits.amax(dim=1).sum()) * visits.shape[1]



@pytest.mark.parametrize("rb,group", [(128, 1), (2048, 2)])
@pytest.mark.parametrize("lanes", [16, 8, 4])
def test_narrower_groups_equal_block_wide(scenes, rb, group, lanes):
    """The plain K1 with termination per group of 32 / P lanes (K1 at P
    row slices a lane: a warp holds 32 / P lanes) gives the block-wide
    loop's winners and distances on every lane whose nearest hit lies
    within its budget, and no group visits more than the 32-lane group
    that holds it."""
    st, _ = scenes
    o, d, bud = _fan(4096 + 37, seed=11, el_lo=-0.3, el_hi=1.2,
                     budgets=(0.0, 4.0, 25.0, 1000.0))
    bud[:64] = 0.0
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(
        st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(bud),
        ray_block=rb, group=group)
    entry, t_last = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                                 kernels=False)
    nvisit, order, ranked = CT._rank(entry[:, :C2])
    args = (nvisit, order, ranked, o, d, t_last, st.coef, st.fetch)
    gate = (inv_d, bud, st.chunk_lo, st.chunk_hi)
    kw = dict(tc=st.chunk_size, group=group, t_min=0.0)
    bt, bi, rows, visits, _ = CT._sweep_plain(*args, *gate, **kw,
                                              t_max=1000.0, with_visits=True,
                                              lanes=lanes)
    *_, visits32, _ = CT._sweep_plain(*args, *gate, **kw, t_max=1000.0,
                                      with_visits=True)
    bt_w, bi_w = _sweep_block_wide(*args, **kw)
    cap = torch.clamp_max(bud, 1000.0)
    ok, ok_w = (bt <= cap) & (cap > 0), (bt_w <= cap) & (cap > 0)
    assert torch.equal(ok, ok_w)
    assert 0.1 < float(ok.float().mean()) < 0.9
    assert torch.equal(bt[ok], bt_w[ok]) and torch.equal(bi[ok], bi_w[ok])
    assert torch.equal(rows[ok], st.fetch[bi[ok].long()])
    assert visits.shape == (nvisit.shape[0], o.shape[0] // nvisit.shape[0]
                            // lanes)
    per32 = visits.view(visits.shape[0], -1, 32 // lanes)
    assert (per32 <= visits32[..., None]).all()
    assert int(visits.sum()) < int(visits32.sum()) * (32 // lanes)


def _gated_sweep(st, o, d, bud, rb, group, lanes):
    """The prep, the ranking and the gated plain K1 on rays o, d, bud:
    (K1's positional arguments without the gate's, the gate's, the sweep's
    best_t, best_idx, rows, visits and tested)."""
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(
        st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(bud),
        ray_block=rb, group=group)
    entry, t_last = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                                 kernels=False)
    nvisit, order, ranked = CT._rank(entry[:, :C2])
    args = (nvisit, order, ranked, o, d, t_last, st.coef, st.fetch)
    gate = (inv_d, bud, st.chunk_lo, st.chunk_hi)
    out = CT._sweep_plain(*args, *gate, tc=st.chunk_size, group=group,
                          t_min=0.0, t_max=1000.0, with_visits=True,
                          lanes=lanes)
    return (args, gate, *out)


def _union_needed(st, o, inv_d, bud, bt, lanes):
    """Per group of `lanes` lanes, the chunks one of its lanes needs at its
    final best_t: its own slab test keeps the chunk's box with an entry
    <= best_t (chip_smoke.py's lane_kept, united over the group)."""
    keep, tn0 = CT._slab_keep(st.chunk_lo[None], st.chunk_hi[None],
                              o[:, None], inv_d[:, None],
                              torch.clamp_max(bud, 1000.0)[:, None])
    need = keep & (tn0 <= bt[:, None])
    return need.view(-1, lanes, need.shape[1]).any(dim=1).sum(dim=1)


@pytest.mark.parametrize("lanes", [32, 8])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("rb", [128, 2048])
def test_box_gate_equals_block_wide(scenes, rb, group, lanes):
    """The plain K1 with the box gate (a group tests a chunk only if one
    of its lanes keeps the chunk's box entered within its best_t) gives the
    ungated block-wide loop's winners and distances on every lane whose
    nearest hit lies within its budget, on fans with sky rays, escaping
    rays and budgets 0 / 4 / 25 / 1000, at every supergroup size and at
    the warp widths of P = 1 and 4; a group tests no more stages than it
    visits chunks, and no fewer than its lanes need."""
    st, _ = scenes
    o, d, bud = _fan(4096 + 37, seed=13, el_lo=-0.3, el_hi=1.2,
                     budgets=(0.0, 4.0, 25.0, 1000.0))
    bud[:64] = 0.0
    args, gate, bt, bi, rows, visits, tested = _gated_sweep(
        st, o, d, bud, rb, group, lanes)
    bt_w, bi_w = _sweep_block_wide(*args, tc=st.chunk_size, group=group,
                                   t_min=0.0)
    cap = torch.clamp_max(gate[1], 1000.0)
    ok, ok_w = (bt <= cap) & (cap > 0), (bt_w <= cap) & (cap > 0)
    assert torch.equal(ok, ok_w)
    assert 0.1 < float(ok.float().mean()) < 0.9
    assert torch.equal(bt[ok], bt_w[ok]) and torch.equal(bi[ok], bi_w[ok])
    assert torch.equal(rows[ok], st.fetch[bi[ok].long()])
    assert (tested <= visits * group).all()
    need = _union_needed(st, args[3], gate[0], gate[1], bt, lanes)
    assert (tested.view(-1) >= need).all() and int(need.sum()) > 0
    # dead lanes keep no box: their groups neither visit nor test
    assert (tested.view(-1)[:64 // lanes] == 0).all()


def _beams(n_beams, per_beam, seed, width_deg):
    """n_beams beams of per_beam rays from one origin, each beam's rays
    within width_deg of its axis and consecutive (a frame's (A, S)
    layout), the axes spread over the full circle; budget 1000."""
    rng = np.random.default_rng(seed)
    w = np.radians(width_deg)
    az = (np.repeat(np.linspace(0, 2 * np.pi, n_beams, endpoint=False),
                    per_beam) + rng.uniform(-w, w, n_beams * per_beam) / 2)
    el = rng.uniform(-0.1, 0.1, az.shape[0]) * w / 0.2
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), d.shape).copy()
    return o, d, np.full(d.shape[0], 1000.0, np.float32)


@pytest.mark.parametrize("case,group", [("beams", 1), ("beams", 2),
                                        ("one_ray", 1)])
def test_box_gate_engages_by_the_rays(scenes, case, group):
    """Where a block holds many narrow beams (a group of 32 lanes = one
    beam of a frame), the gate tests fewer stages than the groups visit
    chunks; where every lane of a block holds the same ray, each visited
    chunk is kept by every lane within its best_t, and the gate skips
    nothing: tested = visits x group. Either way no group tests fewer
    stages than its lanes need."""
    st, _ = scenes
    if case == "beams":
        o, d, bud = _beams(64, 32, seed=3, width_deg=2.0)
    else:
        o, d, bud = _beams(4, 1, seed=5, width_deg=0.0)
        o, d, bud = (np.repeat(x, 512, axis=0) for x in (o, d, bud))
    args, gate, bt, bi, rows, visits, tested = _gated_sweep(
        st, o, d, bud, 2048 if case == "beams" else 512, group, 32)
    assert float(torch.isfinite(bt).float().mean()) > 0.5
    need = _union_needed(st, args[3], gate[0], gate[1], bt, 32)
    assert (tested.view(-1) >= need).all()
    if case == "beams":
        assert int(tested.sum()) < 0.5 * int(visits.sum()) * group
    else:
        assert int(visits.sum()) > 0
        assert torch.equal(tested, visits * group)


@pytest.mark.parametrize("n_ctas,resident,split", [
    (160, 660, 4),       # one KAIST frame, 10 blocks of 2,048 rays
    (3200, 660, 1),      # a batch of 20
    (480, 660, 1),       # the fit's 3 frames
    (0, 660, 1),         # no blocks
    (700, 660, 1),       # more CTAs than the card holds
    (80, 660, 8), (300, 660, 2), (330, 660, 2), (82, 660, 8),
    (83, 660, 4)])
def test_sweep_split_rule(n_ctas, resident, split):
    """K1's row slices a lane: the largest P in {1, 2, 4, 8} whose
    n_ctas * P CTAs the card holds at once, 1 when even P = 2 does not
    fit."""
    assert CT._sweep_split(n_ctas, resident) == split


@pytest.mark.parametrize("group", [1, 4])
def test_sweep_counts_its_group_on_the_plain_path(scenes, group,
                                                  monkeypatch):
    """On the CPU the K1 wrapper runs the plain version at the caller's
    group (counted here), and its launch counters (`launches`,
    `grouped_launches`, `last_group`) stay where they were: they count
    the card's launches only, which the card tests check."""
    st, _ = scenes
    o, d, bud = _fan(256, seed=5)
    groups = []
    real = CT._sweep_plain

    def plain(*a, group, **k):
        groups.append(group)
        return real(*a, group=group, **k)

    monkeypatch.setattr(CT, "_sweep_plain", plain)
    before = (CT.sweep.launches, CT.sweep.grouped_launches,
              CT.sweep.last_group)
    CT.sweep_winners(st, torch.from_numpy(o), torch.from_numpy(d),
                     torch.from_numpy(bud), t_min=0.0, t_max=1000.0,
                     ray_block=RB, group=group, kernels=True)
    assert groups and set(groups) == {group}
    assert (CT.sweep.launches, CT.sweep.grouped_launches,
            CT.sweep.last_group) == before


@pytest.mark.parametrize("config,triangles,chunks,group", [
    ("kaist02-1m", 996_002, 3_896, 1), ("kaist02-10m", 9_960_002, 38_912, 4)])
def test_benchmark_scenes_pick_their_prep_group(config, triangles, chunks,
                                                group):
    """The benchmark's urban scenes counted without building them: a box is
    12 triangles and the ground 2, the build pads the chunks to a multiple
    of 8, and the port's rule picks the prep group from that count (no
    configuration sets it)."""
    from portbench.scenes import urban

    conf = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                       / "configs" / f"{config}.json").read_text())
    s = conf["scene"]
    tiny = {k: v for k, v in s.items() if k not in ("kind", "chunk_size")}
    verts, _, n_obj = urban.soup(**{**tiny, "n_buildings": 3})
    assert verts.shape[0] == 2 + 12 * 3 and n_obj == 4
    n = 2 + 12 * s["n_buildings"]
    assert n == triangles
    assert padded_chunks(n, s["chunk_size"]) == chunks
    assert CT._auto_prep_group(chunks) == group
    assert "trace_prep_group" not in conf["radar"]
