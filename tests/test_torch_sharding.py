"""The port's multi-device layouts (radarays_ros_tpu_torch.parallel) against
the JAX package's (radarays_ros_tpu/parallel/sharding.py) on the virtual
CPU mesh of tests/conftest.py.

The port runs in 4 spawned ranks of one gloo process group on the CPU
(parallel/launch.py:run_ranks, one spawn for the whole module), with the
plain versions of its kernels; the reference runs on 4 of the 8 virtual
devices, with the same mesh shapes (4; 2 x 2). Both take the same scene,
poses and the reference's own cone, Perlin and uniform draws for its key.
Frames are held to the frame contract of tests/test_oracle.py:70-87
(`_assert_frame_contract`); the layouts whose ranks cut no sum apart are
also held bit for bit to the port's own unsharded frame.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.geom.scene import Scene as JxScene
from radarays_ros_tpu.geom.scene import shard_scene_arrays
from radarays_ros_tpu.parallel import sharding as JSH
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.sim.pipeline import simulate_frame_jit as jx_frame

from radarays_ros_tpu_torch.geom.primitives import make_box, make_urban_scene
from radarays_ros_tpu_torch.geom.scene import (INVALID_OBJ_ID, Scene,
                                               shard_scene_host)
from radarays_ros_tpu_torch.parallel.dryrun import (dryrun_multidevice,
                                                    layouts_rank)
from radarays_ros_tpu_torch.parallel.launch import run_ranks
from radarays_ros_tpu_torch.sim.config import (RadarModelConfig,
                                               params_from_numpy)
from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
from radarays_ros_tpu_torch.trace.api import trace

from test_torch_pipeline import _assert_frame_contract

torch.set_num_threads(2)

WORLD = 4
_MATS = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),    # air
         dict(velocity=0.15, ambient=1.0, diffuse=0.2, specular=300.0),
         dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)]
# tests/test_sharding.py's frame
_CFG = dict(n_angles=16, n_cells=64, n_samples=4, n_reflections=2,
            resolution=0.5, signal_denoising=1,
            signal_denoising_triangular_width=5,
            signal_denoising_triangular_mode=0.4, ambient_noise=2)
# name -> (the port's layout, the reference's function and mesh, overrides)
_LAYOUTS = {
    "az": ("az", JSH.simulate_frame_sharded, lambda: JSH.make_mesh(WORLD), {}),
    "az_smp": ("az_smp", JSH.simulate_frame_sharded_2d,
               lambda: JSH.make_mesh_2d(n_az=WORLD // 2, n_smp=2), {}),
    "az_smp_max": ("az_smp", JSH.simulate_frame_sharded_2d,
                   lambda: JSH.make_mesh_2d(n_az=WORLD // 2, n_smp=2),
                   dict(signal_denoising=0, scroll_image=3, ambient_noise=1)),
    "scene": ("scene", JSH.simulate_frame_scene_sharded,
              lambda: JSH.make_mesh_scene(WORLD), {}),
    "az_scene": ("az_scene", JSH.simulate_frame_sharded_az_scene,
                 lambda: JSH.make_mesh_az_scene(n_az=WORLD // 2, n_scene=2),
                 {}),
}
_KEY = jax.random.PRNGKey(7)
_LR = 1e-2


def _parts():
    walls = make_box((0, 0, 0), (40.0, 40.0, 8.0))[:, ::-1, :]
    return [walls, make_box((8.0, 0, 0), (2.0, 2.0, 8.0))]


def _jx_inputs(key, cfg):
    """The reference frame's own random draws for `key`: the cone draws
    (theta, radial), the Perlin row offsets and the uniform field."""
    k_cone, k_noise = jax.random.split(key)
    k_angle, k_radius = jax.random.split(k_cone)
    theta = jax.random.uniform(k_angle, (cfg.n_samples,), jnp.float32,
                               -jnp.pi, jnp.pi)
    radial = jax.random.normal(k_radius, (cfg.n_samples,), jnp.float32)
    k_begin, k_uni = jax.random.split(k_noise)
    return dict(
        cone_draws=(np.array(theta), np.array(radial)),
        random_begin=np.array(jax.random.randint(k_begin, (cfg.n_angles,),
                                                  0, 1000)),
        uniform=np.array(jax.random.uniform(k_uni, (cfg.n_angles,
                                                    cfg.n_cells),
                                            jnp.float32)))


def _urban_rays(n=256, seed=3):
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.uniform(-0.05, 0.05, n)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), (n, 3)).copy()
    return o, d


@pytest.fixture(scope="module")
def world():
    """Both packages' scene, parameters and config, the reference's random
    inputs, the training target and the port's ranks' results (one spawn
    of WORLD ranks for every layout, the step, the traces and the
    refusal)."""
    cfg = RadarModelConfig(**_CFG)
    jcfg = JCFG.RadarModelConfig(**_CFG)
    jparams = JCFG.RadarParams.make(JCFG.Materials.from_list(_MATS), [1, 2],
                                    beam_width_deg=4.0)
    m = jparams.materials
    params_np = tuple(np.asarray(x) for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        jparams.object_materials, jparams.beam_width))
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                    (cfg.n_angles, 1))
    inputs = _jx_inputs(_KEY, cfg)
    sa = JxScene.compose(_parts(), chunk_size=8).device_arrays(cache=False)
    # the training step fits an opaque wall from a perturbed start
    # (tests/test_sharding.py): the reference's gradient is NaN under total
    # internal reflection, which a transmitting wall meets
    jtrue = JCFG.RadarParams.make(JCFG.Materials.from_list(
        [_MATS[0], dict(_MATS[1], velocity=0.0), _MATS[2]]), [1, 2],
        beam_width_deg=4.0)
    target = np.asarray(jx_frame(sa, jtrue, jcfg, poses, _KEY).image_float)
    mt = jtrue.materials
    jparams0 = jtrue._replace(materials=mt._replace(
        ambient=mt.ambient.at[1].set(0.3)))
    params0_np = tuple(np.asarray(x) for x in (
        *jparams0.materials, jparams0.object_materials, jparams0.beam_width))
    host = Scene.compose(_parts(), chunk_size=8).host_arrays(cache=False)
    parts, names = make_urban_scene(n_buildings=24, extent=60.0, seed=3)
    urban = Scene.compose(parts, names, chunk_size=16).host_arrays(
        cache=False)
    o, d = _urban_rays()
    frames = [(name, spec[0], spec[3]) for name, spec in _LAYOUTS.items()]
    ranks = run_ranks(
        layouts_rank, WORLD, backend="gloo", device="cpu",
        args=((host, params_np, cfg, poses, inputs), frames,
              (target, _LR, params0_np), (urban, o, d), True))
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, jparams0=jparams0,
                params=params_from_numpy(*params_np), sa=sa, host=host,
                poses=poses, inputs=inputs, target=target, urban=urban,
                rays=(o, d), ranks=ranks)


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_layout_matches_reference_layout(world, name):
    """Each layout's frame, in every rank of the port, against the
    reference's layout on the same mesh shape under the frame contract."""
    _, jfn, jmesh, overrides = _LAYOUTS[name]
    jcfg = world["jcfg"].replace(**overrides)
    ref = jfn(world["sa"], world["jparams"], jcfg, world["poses"], _KEY,
              jmesh())
    u8, img, max_val = world["ranks"][name]
    assert u8.shape == (jcfg.n_cells, jcfg.n_angles) and u8.max() > 0
    _assert_frame_contract(img, max_val, u8, ref.image_float, ref.max_val,
                           ref.image_u8)


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_layout_equals_unsharded_port_frame(world, name):
    """Each layout against the port's unsharded simulate_frame on the same
    inputs: bit for bit where no rank cuts a sum apart (azimuth rows,
    scene shards, the MAX over samples), and within the frame contract
    where the SUM over "smp" reassociates the splat."""
    cfg = world["cfg"].replace(**_LAYOUTS[name][3])
    st = Scene.compose(_parts(), chunk_size=8).to_device("cpu")
    kw = {k: torch.from_numpy(v) for k, v in world["inputs"].items()
          if k != "cone_draws"}
    want = simulate_frame(st, world["params"], cfg,
                          torch.from_numpy(world["poses"]),
                          cone_draws=tuple(map(torch.from_numpy,
                                               world["inputs"]["cone_draws"])),
                          **kw)
    got = world["ranks"][name]
    if name == "az_smp":
        _assert_frame_contract(got[1], got[2], got[0], want.image_float,
                               want.max_val, want.image_u8)
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


def test_shard_scene_host_matches_reference(monkeypatch):
    """shard_scene_host against the reference's shard_scene_arrays
    (tests/test_sharding.py:127-144): chunk-contiguous shards, padded with
    far chunks to a multiple of 8, field for field bit-equal."""
    from radarays_ros_tpu.native import builder as native_builder

    monkeypatch.setattr(native_builder, "available", lambda: False)
    monkeypatch.setenv("RADARAYS_ORDER_VARIANT", "sah")
    parts, names = make_urban_scene(n_buildings=24, extent=60.0, seed=3)
    host = Scene.compose(parts, names, chunk_size=16).host_arrays(cache=False)
    sa = JxScene.compose(parts, names, chunk_size=16).device_arrays(
        cache=False)
    C = host.chunk_lo.shape[0]
    for n in (1, 3, WORLD):
        shards = shard_scene_host(host, n)
        ref = shard_scene_arrays(sa, n)
        per = -(-C // n)
        per += (-per) % 8
        assert len(shards) == n
        for i, sh in enumerate(shards):
            assert sh.chunk_size == 16 and sh.chunk_lo.shape == (per, 3)
            assert sh.verts.shape == (per * 16, 3, 3)
            for got, want in ((sh.verts, ref.verts), (sh.obj_ids,
                                                      ref.obj_ids),
                              (sh.normals, ref.normals),
                              (sh.planes_o, ref.planes_o),
                              (sh.chunk_lo, ref.chunk_aabb_lo),
                              (sh.chunk_hi, ref.chunk_aabb_hi)):
                np.testing.assert_array_equal(got, np.asarray(want[i]))
        # the first shards' leading chunks are the build's leading chunks
        np.testing.assert_array_equal(
            np.concatenate([s.verts for s in shards])[:host.verts.shape[0]],
            host.verts)
        pad = np.concatenate([s.obj_ids for s in shards])[
            host.verts.shape[0]:]
        assert (pad == INVALID_OBJ_ID).all()
        assert all(np.isfinite(s.normals).all() for s in shards)


def test_combine_trace_shards_equals_unsharded_trace(world):
    """Each rank traces the urban rays against its shard on the "sweep"
    engine and combine_trace_shards merges them: bit for bit the unsharded
    trace's hit, t and obj_id (tests/test_sharding.py:166-207)."""
    o, d = world["rays"]
    from radarays_ros_tpu_torch.geom.scene import scene_tensors

    ref = trace(scene_tensors(world["urban"], "cpu"), torch.from_numpy(o),
                torch.from_numpy(d), engine="sweep")
    hit, t, normal, obj_id, _ = world["ranks"]["traces"]
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(hit, ref.hit.numpy())
    np.testing.assert_array_equal(t[hit], ref.t.numpy()[hit])
    assert np.isinf(t[~hit]).all()
    np.testing.assert_array_equal(obj_id, ref.obj_id.numpy())
    np.testing.assert_array_equal(normal, ref.normal.numpy())


def test_train_step_matches_reference(world):
    """One train_step_sharded over 4 ranks against the reference's on 4
    devices, from the same perturbed wall: the loss within 1e-5 relative,
    every updated parameter within 1e-5 of the step's largest entry."""
    mesh = JSH.make_mesh(WORLD)
    jloss, jnew = JSH.train_step_sharded(
        world["sa"], world["jparams0"], world["jcfg"], world["poses"], _KEY,
        world["target"], mesh, lr=_LR)
    loss, new = world["ranks"]["train"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    j0, jn = world["jparams0"], jnew
    old = [np.asarray(x) for x in (*j0.materials, j0.beam_width)]
    want = [np.asarray(x) for x in (*jn.materials, jn.beam_width)]
    got = [new[i] for i in (0, 1, 2, 3, 5)]
    step = max(float(np.abs(w - o).max()) for w, o in zip(want, old))
    assert step > 0 and abs(float(got[1][1]) - 0.3) > 0      # moved
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * step)


def test_mesh_that_does_not_divide_azimuths_is_refused(world):
    assert "must divide" in world["ranks"]["refused"]


def test_scene_axis_outside_a_layout_is_ignored(world):
    """Outside a layout no group is registered under the axis name: the
    frame with trace_scene_axis set equals the frame without, bit for
    bit."""
    st = Scene.compose(_parts(), chunk_size=8).to_device("cpu")
    kw = dict(cone_draws=tuple(map(torch.from_numpy,
                                   world["inputs"]["cone_draws"])),
              random_begin=torch.from_numpy(world["inputs"]["random_begin"]))
    pose = torch.from_numpy(world["poses"][0])
    a = simulate_frame(st, world["params"], world["cfg"], pose, **kw)
    b = simulate_frame(st, world["params"],
                       world["cfg"].replace(trace_scene_axis="scene"), pose,
                       **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dryrun_multidevice_on_two_ranks():
    """The dry run (every layout once and one training step) over 2 gloo
    ranks on the CPU."""
    out = dryrun_multidevice(2, device="cpu", backend="gloo")
    assert {"az", "az_smp", "scene", "az_scene", "train"} <= set(out)
    assert np.isfinite(out["train"][0])
