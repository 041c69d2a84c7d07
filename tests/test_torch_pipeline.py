"""The port's frame (radarays_ros_tpu_torch.sim) against the JAX package and
the independent NumPy oracle, under the frame contract of
tests/test_oracle.py:70-87.

The reference frame runs with trace_engine="pallas3" and draw_method=
"pallas" (Pallas kernels in interpret mode); the port runs its plain
versions (the kernel wrappers on CPU tensors). PRNG streams differ between
the packages, so the cone directions and the Perlin row offsets are taken
from the reference's keys and handed to the port as explicit inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.geom.scene import Scene as JxScene
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.sim.pipeline import (simulate_frame_jit,
                                           simulate_frames_jit)
from radarays_ros_tpu.wave.cone import sample_cone_local as jx_cone

from radarays_ros_tpu_torch.geom.primitives import make_box
from radarays_ros_tpu_torch.geom.scene import Scene, bake_tri_aux
from radarays_ros_tpu_torch.image.perlin import perlin_affine_rows
from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams, params_from_numpy)
from radarays_ros_tpu_torch.sim.pipeline import (float_u8_image,
                                                 simulate_frame,
                                                 simulate_frames)
from radarays_ros_tpu_torch.sim import pipeline as P
from radarays_ros_tpu_torch.sim.radar import Radar
from radarays_ros_tpu_torch.utils.transforms import make_pose

from numpy_oracle import simulate_frame_oracle

torch.set_num_threads(2)

_MATS = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),    # air
         dict(velocity=0.0, ambient=0.9, diffuse=0.1, specular=200.0),  # wall
         dict(velocity=0.0, ambient=0.5, diffuse=0.4, specular=60.0)]   # stone
_OBJ_MATS = [1, 2, 2]
_CFG = dict(n_angles=16, n_cells=128, resolution=0.25, n_samples=6,
            beam_sample_dist=2, n_reflections=3, record_multi_reflection=True,
            signal_denoising=1, signal_denoising_triangular_width=7,
            signal_denoising_triangular_mode=0.4, ambient_noise=2,
            ambient_noise_at_signal_0=0.2, ambient_noise_at_signal_1=0.05,
            ambient_noise_energy_max=0.3, ambient_noise_energy_min=0.1,
            scroll_image=5, opaque_materials=True, trace_ray_block=128)


def _parts():
    # closed room (normals inward via reversed winding) + two pillars
    return [make_box((0, 0, 0), (40.0, 40.0, 10.0))[:, ::-1, :],
            make_box((8.0, 2.0, 0.0), (2.0, 2.0, 10.0)),
            make_box((-6.0, -7.0, 0.0), (4.0, 1.0, 10.0))]


def _both_params(mats):
    """The reference's RadarParams for `mats` and the port's copy."""
    jparams = JCFG.RadarParams.make(JCFG.Materials.from_list(mats),
                                    _OBJ_MATS, beam_width_deg=15.0)
    m = jparams.materials
    return jparams, params_from_numpy(*(np.asarray(x) for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        jparams.object_materials, jparams.beam_width)))


@pytest.fixture(scope="module")
def world():
    parts = _parts()
    scene = Scene.compose(parts, ["walls", "pillar", "slab"], chunk_size=8)
    jparams, params = _both_params(_MATS)
    sa = JxScene.compose(parts, chunk_size=8).device_arrays(cache=False)
    return scene, scene.to_device("cpu"), params, sa, jparams


def _jx_cfg(**kw):
    return JCFG.RadarModelConfig(**{**_CFG, **kw}, trace_engine="pallas3",
                                 draw_method="pallas")


# the pillar and the slab transmit (velocity > 0): refraction children live
_MATS_T = [_MATS[0], _MATS[1],
           dict(velocity=0.12, ambient=0.5, diffuse=0.4, specular=60.0)]


def _inputs(key, cfg, beam_width):
    """The reference frame's own cone and Perlin draws for `key`."""
    k_cone, k_noise = jax.random.split(key)
    dirs = np.array(jx_cone(k_cone, beam_width, cfg.n_samples,
                            cfg.beam_sample_dist,
                            cfg.beam_sample_dist_normal_p_in_cone))
    k_begin, _ = jax.random.split(k_noise)
    begin = np.array(jax.random.randint(k_begin, (cfg.n_angles,), 0, 1000))
    return dirs, begin


def _assert_frame_contract(img, mv, u8, o_img, o_max, o_u8):
    """tests/test_oracle.py:70-87: image_float within atol 2e-4*max and
    rtol 2e-3, max_val within rtol 1e-4, u8 within 1 on >= 99.5% of pixels
    and never more than 3 apart."""
    o_img = np.asarray(o_img, np.float64)
    assert o_img.max() > 0, "reference frame is empty"
    np.testing.assert_allclose(np.asarray(img, np.float64), o_img,
                               atol=2e-4 * o_img.max(), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(mv, np.float64),
                               np.asarray(o_max, np.float64),
                               rtol=1e-4, atol=1e-6)
    diff = np.abs(np.asarray(u8).astype(int) - np.asarray(o_u8).astype(int))
    assert (diff <= 1).mean() >= 0.995, f"{(diff > 1).sum()} px, max {diff.max()}"
    assert diff.max() <= 3


@pytest.mark.parametrize("baked", [False, True])
def test_frame_matches_reference_frame(world, baked):
    scene, st, params, sa, jparams = world
    cfg = RadarModelConfig(**_CFG, trace_aux_baked=baked)
    if baked:
        om = params.object_materials
        st = bake_tri_aux(st, om.float()[st.obj_ids.clamp(0, om.shape[0] - 1)
                                         .long()])
    pose = make_pose([0.5, -0.3, 1.0])
    key = jax.random.PRNGKey(3)
    ref = simulate_frame_jit(sa, jparams, _jx_cfg(), jnp.asarray(pose),
                             tuple(jax.random.split(key)))
    dirs, begin = _inputs(key, cfg, jparams.beam_width)
    got = simulate_frame(st, params, cfg, torch.from_numpy(pose),
                         local_dirs=torch.from_numpy(dirs),
                         random_begin=torch.from_numpy(begin))
    assert got.image_u8.shape == (cfg.n_cells, cfg.n_angles)
    assert (got.image_u8 > 0).any()
    _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                           ref.image_float, ref.max_val, ref.image_u8)
    f = float_u8_image(got, cfg).numpy()
    assert np.abs(f - got.image_u8.numpy()).max() <= 0.5 + 1e-4


@pytest.mark.parametrize("opaque,multipath", [(False, False), (False, True),
                                              (True, True)])
def test_refraction_and_multipath_frame_matches_reference(world, opaque,
                                                          multipath):
    """The refraction tree (the wave tensor doubles every pass) and the
    multipath air returns against the reference's frame, whose signal order
    (pass by pass, path then air; kind-major on the opaque path) fixes the
    f32 sum order of the binning."""
    scene, st, _, sa, _ = world
    jparams, params = _both_params(_MATS if opaque else _MATS_T)
    kw = dict(opaque_materials=opaque, record_multi_path=multipath,
              multipath_threshold=0.3)
    cfg = RadarModelConfig(**{**_CFG, **kw})
    pose = make_pose([0.5, -0.3, 1.0])
    key = jax.random.PRNGKey(5)
    ref = simulate_frame_jit(sa, jparams, _jx_cfg(**kw), jnp.asarray(pose),
                             tuple(jax.random.split(key)))
    dirs, begin = _inputs(key, cfg, jparams.beam_width)
    got = simulate_frame(st, params, cfg, torch.from_numpy(pose),
                         local_dirs=torch.from_numpy(dirs),
                         random_begin=torch.from_numpy(begin))
    _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                           ref.image_float, ref.max_val, ref.image_u8)
    # the branch under test is live: it changes the frame
    base = simulate_frame(st, params, cfg.replace(
        opaque_materials=True, record_multi_path=False),
        torch.from_numpy(pose), local_dirs=torch.from_numpy(dirs),
        random_begin=torch.from_numpy(begin))
    assert not torch.equal(base.image_float, got.image_float)


def test_two_frame_batch_matches_reference_batch(world):
    scene, st, params, sa, jparams = world
    cfg = RadarModelConfig(**_CFG)
    poses = np.stack([make_pose([0.5, -0.3, 1.0]),
                      make_pose([-1.0, 2.0, 1.5], [0, 0, 0.2588, 0.9659])])
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    ref = simulate_frames_jit(sa, jparams, _jx_cfg(), jnp.asarray(poses),
                              keys)
    ins = [_inputs(k, cfg, jparams.beam_width) for k in keys]
    got = simulate_frames(st, params, cfg, torch.from_numpy(poses),
                          local_dirs=torch.from_numpy(np.stack(
                              [i[0] for i in ins])),
                          random_begin=torch.from_numpy(np.stack(
                              [i[1] for i in ins])))
    assert got.image_u8.shape == (2, cfg.n_cells, cfg.n_angles)
    for n in range(2):
        _assert_frame_contract(got.image_float[n], got.max_val[n],
                               got.image_u8[n], ref.image_float[n],
                               ref.max_val[n], ref.image_u8[n])


def test_frame_matches_numpy_oracle(world):
    scene, st, params, _, _ = world
    cfg = RadarModelConfig(**_CFG)
    pose = make_pose([0.5, -0.3, 1.0])
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    from radarays_ros_tpu_torch.wave.cone import sample_cone_local

    dirs = sample_cone_local(gen, params.beam_width, cfg.n_samples,
                             cfg.beam_sample_dist, 0.8)
    begin = torch.from_numpy(rng.integers(0, 1000, cfg.n_angles))
    got = simulate_frame(st, params, cfg, torch.from_numpy(pose),
                         local_dirs=dirs, random_begin=begin)
    cols = (cfg.scroll_image + np.arange(cfg.n_angles)) % cfg.n_angles
    y = torch.from_numpy(cols.astype(np.float32))
    lo, hi = (cfg.ambient_noise_perlin_scale_low,
              cfg.ambient_noise_perlin_scale_high)
    p = cfg.ambient_noise_perlin_p_low * perlin_affine_rows(
        begin, y * lo, lo, cfg.n_cells) + (1.0 - cfg.ambient_noise_perlin_p_low) \
        * perlin_affine_rows(begin, y * hi, hi, cfg.n_cells)
    weights, mode = cfg.denoiser()
    mats = {k: [m[k] for m in _MATS]
            for k in ("velocity", "ambient", "diffuse", "specular")}
    o_u8, o_img, o_max = simulate_frame_oracle(
        scene.verts, scene.obj_ids, mats, _OBJ_MATS, cfg,
        dirs.numpy().astype(np.float64), pose.astype(np.float64),
        denoise_weights=weights, denoise_mode=mode,
        noise_field=p.numpy().astype(np.float64))
    _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                           o_img, o_max, o_u8)


def test_config_copy_matches_reference_fields_and_defaults():
    """The port's RadarModelConfig is a copy of the reference's: the same
    field names in the same order, with the same defaults, and the same
    denoise taps for them."""
    import dataclasses

    ours = [(f.name, f.default)
            for f in dataclasses.fields(RadarModelConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(JCFG.RadarModelConfig)]
    assert ours == ref
    for mode in (0, 1, 2, 3):
        w, m = RadarModelConfig(signal_denoising=mode).denoiser()
        jw, jm = JCFG.RadarModelConfig(signal_denoising=mode).denoiser()
        assert m == jm
        if jw is None:
            assert w is None
        else:
            np.testing.assert_array_equal(w, np.asarray(jw))


def test_radar_front_end(world):
    scene, _, _, _, _ = world
    mats = Materials.from_list(_MATS)
    params = RadarParams.make(mats, _OBJ_MATS, beam_width_deg=15.0)
    cfg = RadarModelConfig(**{**_CFG, "opaque_materials": False})
    radar = Radar(scene, params, cfg, seed=1, device="cpu")
    assert radar.cfg.opaque_materials and radar.cfg.trace_aux_baked
    a = radar.simulate_image(make_pose([0.5, -0.3, 1.0]))
    b = radar.simulate_image()                    # last pose, fresh noise
    assert a.shape == (cfg.n_cells, cfg.n_angles) and a.dtype == np.uint8
    assert a.max() > 0 and not np.array_equal(a, b)
    radar.load_materials([_MATS[0], dict(velocity=0.15, ambient=0.4,
                                         diffuse=0.5, specular=40.0)],
                         [1, 1, 1])
    assert not radar.cfg.opaque_materials
    c = radar.simulate_image()          # the refraction tree now renders
    assert c.shape == a.shape and c.max() > 0 and not np.array_equal(b, c)


def test_radar_beam_width_update_rebuilds_cone(world, monkeypatch):
    """Radar keeps the cone draws and rebuilds the directions from the
    current beam width every frame, as the reference keeps its cone key
    (sim/radar.py:190-193 there): after update_params with a doubled beam
    width the next frame's cone offsets double. update_config with a
    beam-shape field and update_params(resample=True) draw a new cone."""
    scene = world[0]
    params = RadarParams.make(Materials.from_list(_MATS), _OBJ_MATS,
                              beam_width_deg=8.0)
    radar = Radar(scene, params, RadarModelConfig(**_CFG), seed=2,
                  device="cpu")
    seen = []
    start = P.start_waves

    def spy(*args, **kw):
        waves, sensor_pos = start(*args, **kw)
        seen.append(waves.dir[0, 0].clone())    # azimuth 0: the beam frame
        return waves, sensor_pos

    monkeypatch.setattr(P, "start_waves", spy)

    def offsets(d):
        return torch.stack([-torch.asin(d[:, 2]),
                            torch.atan2(d[:, 1], d[:, 0])])

    pose = make_pose([0.5, -0.3, 1.0])
    radar.simulate(pose)
    radar.simulate()
    assert torch.equal(seen[0], seen[1])          # the cone is kept
    radar.update_params(params._replace(beam_width=params.beam_width * 2))
    radar.simulate()
    a0, a1 = offsets(seen[1]), offsets(seen[2])
    np.testing.assert_allclose(a1.numpy(), 2.0 * a0.numpy(), rtol=1e-4,
                               atol=1e-7)
    # the reference: the same cone key at twice the width doubles offsets
    key = jax.random.PRNGKey(1)
    from radarays_ros_tpu.wave.cone import sample_cone_offsets
    r1 = np.array(sample_cone_offsets(key, 0.1, 8, 2, 0.8))
    r2 = np.array(sample_cone_offsets(key, 0.2, 8, 2, 0.8))
    np.testing.assert_allclose(r2, 2.0 * r1, rtol=1e-6)
    radar.update_config(beam_sample_dist=1)
    radar.simulate()
    assert radar.cfg.beam_sample_dist == 1
    assert not torch.allclose(offsets(seen[3]), a1)
    radar.update_params(radar.params, resample=True)
    radar.simulate()
    assert not torch.equal(seen[4], seen[3])


def _budget_before_dead_lanes(cfg, waves):
    """trace_budget without the zero budget of invalid waves."""
    weights, _ = cfg.denoiser()
    slack = 0 if weights is None else len(weights)
    t_lim = (cfg.n_cells + slack) * cfg.resolution / 0.3
    if cfg.record_multi_path:
        t_lim = 2.0 * t_lim
    return torch.clamp_min(t_lim - waves.time, 0.0) * waves.velocity


@pytest.mark.parametrize("opaque,multipath", [(True, False), (False, True)])
def test_dead_wave_budget_leaves_frames_bit_identical(world, monkeypatch,
                                                      opaque, multipath):
    """Invalid waves get trace budget 0: their signals and children are
    gated by validity, so the frames (image, column maxima, u8) equal bit
    for bit those traced with the full budget, on the opaque path and on
    the refraction tree with multipath; and some budget really changed."""
    scene, st, _, _, _ = world
    _, params = _both_params(_MATS if opaque else _MATS_T)
    cfg = RadarModelConfig(**{**_CFG, "opaque_materials": opaque,
                              "record_multi_path": multipath,
                              "multipath_threshold": 0.3})
    pose = torch.from_numpy(make_pose([0.5, -0.3, 1.0]))
    gen = torch.Generator().manual_seed(4)
    from radarays_ros_tpu_torch.wave.cone import sample_cone_local

    kw = dict(local_dirs=sample_cone_local(
        gen, params.beam_width, cfg.n_samples, cfg.beam_sample_dist, 0.8),
        random_begin=torch.randint(0, 1000, (cfg.n_angles,), generator=gen))
    zeroed = []
    budget = P.trace_budget

    def spy(c, waves):
        b = budget(c, waves)
        zeroed.append(int(((b == 0) & (_budget_before_dead_lanes(c, waves)
                                       > 0)).sum()))
        return b

    monkeypatch.setattr(P, "trace_budget", spy)
    got = simulate_frame(st, params, cfg, pose, **kw)
    assert sum(zeroed) > 0
    monkeypatch.setattr(P, "trace_budget", _budget_before_dead_lanes)
    want = simulate_frame(st, params, cfg, pose, **kw)
    assert (want.image_u8 > 0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_radar_defaults_to_the_card(world):
    """Radar(scene) simulates on the card by default and raises without
    one; it never carries on on the CPU."""
    scene = world[0]
    params = RadarParams.make(Materials.from_list(_MATS), _OBJ_MATS,
                              beam_width_deg=8.0)
    if torch.cuda.is_available():
        assert Radar(scene, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Radar(scene, params)
    assert Radar(scene, params, device="cpu").device.type == "cpu"
