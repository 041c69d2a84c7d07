"""The port's trace extras against the JAX package: the spatial ray sort
(`sort_rays`), the two-phase requeue (`two_phase_cap`), the sweep cap
(`k_chunks`, the reference's culled engine's) and the dense "mxu" engine,
alone and in frames.

The sweep engines run here as their plain versions (the kernel wrappers
take them for CPU tensors). The reference's pallas3 runs in interpret mode.
The trace contract is tests/test_trace.py:77-83 (hit and obj_id equal, t
within 1e-4, normals within 1e-4); against brute, a sorted trace may differ
in obj_id on exact-distance ties only (tests/test_trace.py:343-354).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.geom.primitives import make_box as jx_box
from radarays_ros_tpu.geom.primitives import make_urban_scene as jx_urban
from radarays_ros_tpu.geom.scene import Scene as JxScene
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.sim.pipeline import simulate_frame_jit
from radarays_ros_tpu.sim.radar import Radar as JxRadar
from radarays_ros_tpu.trace import pallas_trace as JP
from radarays_ros_tpu.trace.api import trace as jx_trace

from radarays_ros_tpu_torch.geom.primitives import make_box, make_urban_scene
from radarays_ros_tpu_torch.geom.scene import (Scene, plane_tables,
                                               with_planes)
from radarays_ros_tpu_torch.sim.config import (RadarModelConfig,
                                               params_from_numpy)
from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
from radarays_ros_tpu_torch.sim.radar import Radar
from radarays_ros_tpu_torch.trace import cuda_trace as CT
from radarays_ros_tpu_torch.trace.api import trace

from test_torch_pipeline import _assert_frame_contract

torch.set_num_threads(2)

RB = 128


@pytest.fixture(scope="module")
def town():
    """The reference's sort/two-phase test scene (tests/test_trace.py:
    330-333): 60 buildings, chunk 16, 48 chunks (the flat prep)."""
    parts, names = make_urban_scene(n_buildings=60, extent=80.0, seed=4)
    st = Scene.compose(parts, names, chunk_size=16).to_device("cpu")
    jparts, jnames = jx_urban(n_buildings=60, extent=80.0, seed=4)
    sa = JxScene.compose(jparts, jnames, chunk_size=16).device_arrays(
        cache=False)
    return st, sa


def _incoherent(n, seed, sky_every=5):
    """Random origins over the town and random directions, every
    `sky_every`-th ray turned up (a deep miss), budgets 8 or 1000."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    if sky_every:
        d[::sky_every, 2] = np.abs(d[::sky_every, 2]) + 2.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    bud = rng.choice([8.0, 1000.0], n).astype(np.float32)
    return o, d, bud


def _contract(ref, got, obj_ties=False):
    """The trace contract; with obj_ties, obj_id may differ on under 2 % of
    the lanes, each an exact-distance tie (the two winners' distances
    agree)."""
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(hit, np.asarray(got.hit))
    t_ref, t_got = np.asarray(ref.t), np.asarray(got.t)
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=1e-4, atol=1e-4)
    diff = np.asarray(ref.obj_id) != np.asarray(got.obj_id)
    if obj_ties:
        assert diff.mean() < 0.02
        np.testing.assert_allclose(t_got[diff], t_ref[diff], rtol=1e-4)
    else:
        assert not diff.any(), f"{diff.sum()} obj_id mismatches"
        np.testing.assert_allclose(np.asarray(got.normal),
                                   np.asarray(ref.normal), atol=1e-4)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_ray_sort_key_is_bit_equal_to_reference():
    """The Morton-plus-octant key equals the reference's _ray_sort_key on
    random rays, on rays with zero direction components and on a set whose
    origins are flat in one axis (ext clamped at 1e-6)."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-300, 300, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    d[::11] = -0.0
    flat = o.copy()
    flat[:, 2] = 2.0
    for oo in (o, flat, o[:1]):
        got = CT._ray_sort_key(*_t(oo, d[:oo.shape[0]]))
        want = JP._ray_sort_key(jnp.asarray(oo), jnp.asarray(d[:oo.shape[0]]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(CT._ray_sort_key(*_t(o, d)).numpy())) > 1000


_EXTRAS = {"sort": dict(sort_rays=True), "cap": dict(two_phase_cap=20.0),
           "sort+cap": dict(sort_rays=True, two_phase_cap=20.0)}


@pytest.fixture(scope="module")
def reference_extras(town):
    """The reference's pallas3 traces (interpret) of the incoherent set,
    once per option, and its brute trace."""
    _, sa = town
    o, d, bud = _incoherent(512, seed=42)
    args = (sa, jnp.asarray(o), jnp.asarray(d))
    out = {k: jx_trace(*args, engine="pallas3", t_budget=jnp.asarray(bud),
                       ray_block=RB, **kw) for k, kw in _EXTRAS.items()}
    out["brute"] = jx_trace(*args, engine="brute", t_budget=jnp.asarray(bud))
    return (o, d, bud), out


@pytest.mark.parametrize("extra", list(_EXTRAS))
@pytest.mark.parametrize("engine", ["sweep", "kernel"])
def test_sort_and_two_phase_match_reference_and_brute(town, reference_extras,
                                                      engine, extra):
    """sort_rays and two_phase_cap, alone and together, on both sweep
    engines: equal to the reference's pallas3 with the same options (the
    stable sort blocks the same rays, so even the tie winners agree), and
    to brute up to exact-distance ties; the unsorted single-phase trace
    agrees with the same ties."""
    st, _ = town
    (o, d, bud), ref = reference_extras
    got = trace(st, *_t(o, d), engine=engine, t_budget=torch.from_numpy(bud),
                ray_block=RB, **_EXTRAS[extra])
    assert 0.2 < float(got.hit.float().mean()) < 0.9
    _contract(ref[extra], got)
    _contract(ref["brute"], got, obj_ties=True)
    plain = trace(st, *_t(o, d), engine=engine,
                  t_budget=torch.from_numpy(bud), ray_block=RB)
    _contract(plain, got, obj_ties=True)


def test_two_phase_requeues_only_the_unresolved_lanes(town, monkeypatch):
    """Phase 2 traces the lanes phase 1 left unresolved, compacted to the
    front by the stable sort; those with a budget beyond the cap keep it,
    every other lane gets budget 0."""
    st, _ = town
    o, d, bud = _incoherent(512, seed=7)
    calls = []
    winners = CT.sweep_winners

    def spy(scene, origs, dirs, budget, **kw):
        out = winners(scene, origs, dirs, budget, **kw)
        calls.append((budget.clone(), out[0]))
        return out

    monkeypatch.setattr(CT, "sweep_winners", spy)
    trace(st, *_t(o, d), engine="sweep", t_budget=torch.from_numpy(bud),
          ray_block=RB, two_phase_cap=20.0)
    (b1, t1), (b2, _) = calls
    assert torch.equal(b1, torch.clamp_max(torch.from_numpy(bud), 20.0))
    unresolved = ~(torch.isfinite(t1) & (t1 <= b1))
    front = int(unresolved.sum())
    assert 0 < front < 512
    assert not b2[front:].any()
    live = b2[:front] > 0
    assert live.any() and bool((b2[:front][live] > 20.0).all())
    assert int(live.sum()) == int((unresolved
                                   & (torch.from_numpy(bud) > 20.0)).sum())


@pytest.mark.parametrize("n_rays,tri_chunk", [(500, 2048), (300, 100),
                                              (257, 500)])
def test_mxu_matches_reference_mxu(town, n_rays, tri_chunk):
    """The dense engine against the reference's (its trace_planes), with a
    triangle chunk that does not divide T (768 triangles: chunks of 100
    and 500) and ray counts that do not divide the block; and against
    brute."""
    st, sa = town
    o, d, _ = _incoherent(n_rays, seed=n_rays, sky_every=4)
    kw = dict(ray_block=RB, tri_chunk=tri_chunk)
    got = trace(st, *_t(o, d), engine="mxu", **kw)
    ref = jx_trace(sa, jnp.asarray(o), jnp.asarray(d), engine="mxu", **kw)
    assert 0.2 < float(got.hit.float().mean()) < 0.9
    _contract(ref, got)
    # against brute on a fan from the street (the incoherent set starts
    # rays below the ground and inside buildings, where the ground and the
    # building floors tie at z = 0, and brute's winner among them is the
    # one its own rounding puts nearest)
    fo, fd = _fan(n_rays, seed=n_rays)
    _contract(trace(st, *_t(fo, fd), engine="brute"),
              trace(st, *_t(fo, fd), engine="mxu", **kw))
    # the scene's own plane tables give the same trace
    again = trace(with_planes(st), *_t(o, d), engine="mxu", **kw)
    for a, b in zip(got, again):
        assert b is None if a is None else torch.equal(a, b)


def test_plane_tables_bit_identical_to_host_build():
    """The mxu engine's device tables equal the host build's planes_o (the
    reference's _triangle_planes order) bit for bit."""
    parts, names = make_urban_scene(n_buildings=300, extent=80.0, seed=4)
    h = Scene.compose(parts, names, chunk_size=16).host_arrays(cache=False)
    po, pd = plane_tables(torch.from_numpy(h.verts))
    np.testing.assert_array_equal(po.numpy(), h.planes_o)
    np.testing.assert_array_equal(pd.numpy(), h.planes_o[:, :3])
    # bit for bit: the ground's and the boxes' feet give -0 offsets
    assert (h.planes_o[:, 3].view(np.uint32) == 0x80000000).any()
    np.testing.assert_array_equal(po.numpy().view(np.uint32),
                                  h.planes_o.view(np.uint32))


def _fan(n, seed):
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(-0.2, 0.5, n)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), (n, 3)).copy()
    return o, d


def test_k_chunks_caps_sweep_as_reference_culled(town):
    """trace_k_chunks on the sweep engine equals the reference's culled
    engine under the same cap (hit and obj_id exactly, t within 1e-4), both
    warn, and the cap binds (the capped trace misses hits the full one
    finds); no warning without a cap."""
    st, sa = town
    o, d = _fan(512, seed=3)
    K = 3
    with pytest.warns(UserWarning, match="NO LONGER GUARANTEED EXACT"):
        got = trace(st, *_t(o, d), engine="sweep", ray_block=RB,
                    prep_group=1, k_chunks=K)
    with pytest.warns(UserWarning, match="NO LONGER GUARANTEED EXACT"):
        ref = jx_trace(sa, jnp.asarray(o), jnp.asarray(d), engine="culled",
                       ray_block=RB, k_chunks=K)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.obj_id.numpy(), np.asarray(ref.obj_id))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-4, atol=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        full = trace(st, *_t(o, d), engine="sweep", ray_block=RB,
                     prep_group=1, k_chunks=None)
    assert int(full.hit.sum()) > int(got.hit.sum())


# ------------------------------------------------------------------ frames

_MATS = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
         dict(velocity=0.15, ambient=1.0, diffuse=0.2, specular=300.0),
         dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)]
# tests/test_pipeline.py:428-446
_BOX_CFG = dict(n_angles=8, n_cells=96, n_samples=6, n_reflections=2,
                resolution=0.3, signal_denoising=0, ambient_noise=0,
                trace_ray_block=128)


def _box_parts(box):
    walls = box((0, 0, 0), (40.0, 40.0, 8.0))[:, ::-1, :]
    return [walls, box((8.0, 0, 0), (2.0, 2.0, 8.0))]


@pytest.fixture(scope="module")
def box_world():
    """The reference's box scene (tests/conftest.py:box_scene) and its
    materials in both packages; the wall transmits (refraction tree)."""
    scene = Scene.compose(_box_parts(make_box), ["walls", "pillar"],
                          chunk_size=8)
    jscene = JxScene.compose(_box_parts(jx_box), ["walls", "pillar"],
                             chunk_size=8)
    jparams = JCFG.RadarParams.make(JCFG.Materials.from_list(_MATS), [1, 2],
                                    beam_width_deg=4.0)
    m = jparams.materials
    params = params_from_numpy(*(np.asarray(x) for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        jparams.object_materials, jparams.beam_width)))
    return scene, jscene, params, jparams


def _jx_cone(key, width, cfg):
    """The reference frame's cone draws (theta, radial) for its cone key
    (wave/cone.py:sample_cone_offsets), as the port's explicit draws."""
    k_angle, k_radius = jax.random.split(key)
    theta = jax.random.uniform(k_angle, (cfg.n_samples,), jnp.float32,
                               -jnp.pi, jnp.pi)
    radial = jax.random.normal(k_radius, (cfg.n_samples,), jnp.float32)
    assert cfg.beam_sample_dist == 2
    return torch.from_numpy(np.array(theta)), torch.from_numpy(
        np.array(radial))


@pytest.mark.parametrize("extra", [
    dict(trace_two_phase_cap=4.0),
    dict(trace_engine="mxu"),
    dict(trace_engine="sweep", trace_two_phase_cap=4.0)])
def test_frame_with_trace_extra_matches_reference(box_world, extra):
    """A frame with the two-phase requeue (the reference's
    test_full_frame_two_phase_cap_parity configuration), and one with the
    mxu engine, within the frame contract of the reference's frame with
    the same option; the requeue leaves the port's frame bit-identical."""
    scene, jscene, params, jparams = box_world
    engine = extra.get("trace_engine", "kernel")
    cfg = RadarModelConfig(**_BOX_CFG, **{**extra, "trace_engine": engine})
    jcfg = JCFG.RadarModelConfig(**_BOX_CFG, **{
        **extra, "trace_engine": {"kernel": "pallas3", "sweep": "culled",
                                  "mxu": "mxu"}[engine]})
    key = jax.random.PRNGKey(3)
    keys = tuple(jax.random.split(key))
    ref = simulate_frame_jit(jscene.device_arrays(cache=False), jparams,
                             jcfg, jnp.asarray(_pose()), keys)
    st = scene.to_device("cpu")
    draws = _jx_cone(keys[0], jparams.beam_width, cfg)
    got = simulate_frame(st, params, cfg, torch.from_numpy(_pose()),
                         cone_draws=draws)
    _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                           ref.image_float, ref.max_val, ref.image_u8)
    if "trace_two_phase_cap" in extra:
        single = simulate_frame(st, params, cfg.replace(
            trace_two_phase_cap=None), torch.from_numpy(_pose()),
            cone_draws=draws)
        for a, b in zip(got, single):
            assert torch.equal(a, b)


def _pose():
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    return make_pose([0.5, -0.3, 1.0])


@pytest.mark.parametrize("engine", ["brute", "mxu"])
def test_radar_with_unfetching_engine_matches_reference(box_world, engine):
    """Radar bakes the material map and sets trace_aux_baked, but brute and
    mxu return no aux: the material is then gathered by object (it used to
    fail at the first frame). Two frames within the frame contract of the
    reference Radar's on its cone draws; the second reuses the pose. (The
    draws of seed 3: from the same draws, torch's and XLA's sin and cos
    can give cone directions 1 ulp apart, which on some cones moves one
    weak signal of the refraction tree across a discrete boundary.)"""
    scene, jscene, params, jparams = box_world
    cfg = RadarModelConfig(**_BOX_CFG, trace_engine=engine)
    jradar = JxRadar(jscene, jparams, JCFG.RadarModelConfig(
        **_BOX_CFG, trace_engine=engine), seed=3)
    radar = Radar(scene, params, cfg, seed=3, device="cpu")
    assert radar.cfg.trace_aux_baked
    assert (radar._scene_tensors.planes_o is not None) == (engine == "mxu")
    radar._cone_draws = _jx_cone(jradar._cone_key, jparams.beam_width, cfg)
    for pose in (_pose(), None):
        ref = jradar.simulate(pose)
        got = radar.simulate(pose)
        _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                               ref.image_float, ref.max_val, ref.image_u8)
