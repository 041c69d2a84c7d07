"""The port's material fitting (radarays_ros_tpu_torch.opti) against the JAX
package: metrics, the parameter vector, the fit objective's loss and
gradient against jax.value_and_grad of the reference's step loss on the same
cone draws, Adam recovering a material, checkpoints across the two packages,
the black-box optimizer and the GenRadarImage server.

Small sizes (16 azimuths, 128 cells, 6 samples, 2 reflections); the port
runs its plain versions (kernel wrappers on CPU tensors), the reference its
Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.geom.scene import Scene as JxScene
from radarays_ros_tpu.opti import checkpoint as JCK
from radarays_ros_tpu.opti import metrics as JM
from radarays_ros_tpu.opti import optimize as JO
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.sim.pipeline import float_u8_image as jx_float_u8
from radarays_ros_tpu.sim.pipeline import simulate_frame as jx_frame
from radarays_ros_tpu.sim.pipeline import simulate_frame_jit

from radarays_ros_tpu_torch.geom.primitives import make_box
from radarays_ros_tpu_torch.geom.scene import Scene
from radarays_ros_tpu_torch.opti import checkpoint as CK
from radarays_ros_tpu_torch.opti import metrics as M
from radarays_ros_tpu_torch.opti import optimize as O
from radarays_ros_tpu_torch.opti.workload import (RadarImageServer,
                                                  params_to_msg)
from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams, params_from_numpy)
from radarays_ros_tpu_torch.sim.pipeline import (float_u8_image,
                                                 simulate_frame,
                                                 simulate_frames)
from radarays_ros_tpu_torch.sim.radar import Radar
from radarays_ros_tpu_torch.utils.transforms import identity_pose, make_pose
from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

torch.set_num_threads(2)

_TRUE = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
         dict(velocity=0.0, ambient=0.85, diffuse=0.15, specular=900.0),
         dict(velocity=0.1, ambient=0.35, diffuse=0.6, specular=150.0)]
_START = [_TRUE[0],
          dict(velocity=0.05, ambient=0.3, diffuse=0.6, specular=150.0),
          dict(velocity=0.2, ambient=0.9, diffuse=0.05, specular=2000.0)]
_OBJ = [1, 2, 2]
# the fit's physics (benchmarks/opti_scale.py:84-92) at a small size
_CFG = dict(n_angles=16, n_cells=128, resolution=0.25, n_samples=6,
            beam_sample_dist=2, n_reflections=2, energy_max=0.72,
            signal_max=110.0, signal_denoising=1,
            signal_denoising_triangular_width=7,
            signal_denoising_triangular_mode=0.35, ambient_noise=0,
            record_multi_reflection=True, opaque_materials=False,
            trace_ray_block=128)
_PV = dict(material_slots=(1, 2), tune_beam_width=True,
           tune_n_reflections=False)


def _parts():
    return [make_box((0, 0, 0), (40.0, 40.0, 10.0))[:, ::-1, :],
            make_box((8.0, 2.0, 0.0), (2.0, 2.0, 10.0)),
            make_box((-6.0, -7.0, 0.0), (4.0, 1.0, 10.0))]


def _port_params(jparams):
    m = jparams.materials
    return params_from_numpy(*(np.asarray(x) for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        jparams.object_materials, jparams.beam_width)))


def _jx_params(mats, deg):
    return JCFG.RadarParams.make(JCFG.Materials.from_list(mats), _OBJ,
                                 beam_width_deg=deg)


@pytest.fixture(scope="module")
def room():
    parts = _parts()
    st = Scene.compose(parts, chunk_size=8).to_device("cpu")
    sa = JxScene.compose(parts, chunk_size=8).device_arrays(cache=False)
    return st, sa


def _cone_draws(key, cfg):
    """The reference frame's cone draws for `key` (simulate_frame splits it
    into cone and noise keys; sample_cone_offsets splits the cone key)."""
    k_cone, _ = jax.random.split(key)
    k_angle, k_radius = jax.random.split(k_cone)
    theta = jax.random.uniform(k_angle, (cfg.n_samples,), jnp.float32,
                               -jnp.pi, jnp.pi)
    radial = jax.random.normal(k_radius, (cfg.n_samples,), jnp.float32)
    return np.array(theta), np.array(radial)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("name", ["mse", "psnr", "ssim",
                                  "mutual_information",
                                  "normalized_mutual_information",
                                  "variation_of_information"])
def test_metrics_match_reference(name):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 255, (24, 40)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    got = getattr(M, name)(torch.from_numpy(a), torch.from_numpy(b))
    ref = getattr(JM, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-5)
    assert float(M.psnr(a, a)) > 100.0
    if name == "ssim":
        assert float(M.ssim(a, a)) == pytest.approx(1.0, abs=1e-5)


# ------------------------------------------------------------ param vector

def test_param_vector_matches_reference():
    jparams = _jx_params(_TRUE, 8.0)
    params = _port_params(jparams)
    for kw in (dict(material_slots=(1, 2)), _PV):
        pv, jpv = O.ParamVector(**kw), JO.ParamVector(**kw)
        np.testing.assert_array_equal(pv.bounds(), jpv.bounds())
        vec = pv.to_vec(params, n_reflections=3)
        np.testing.assert_array_equal(vec, jpv.to_vec(jparams, 3))
        vec = vec + 0.01 * np.arange(pv.n)
        p2, n_ref = pv.to_params(params, vec)
        j2, j_ref = jpv.to_params(jparams, vec)
        assert n_ref == j_ref
        for a, b in zip(p2.materials, j2.materials):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(float(p2.beam_width),
                                   float(j2.beam_width), rtol=1e-7)


# ------------------------------------------------------------ loss + grad

@pytest.mark.parametrize("n_reflections", [2, 1])
def test_fit_loss_and_gradient_match_reference(room, n_reflections):
    """The multi-frame -PSNR fit objective (benchmarks/opti_scale.py) and
    its gradient w.r.t. the ParamVector's z against jax.value_and_grad of
    the reference's step loss (opti/optimize.py:170-173), on the same cone
    draws and targets: loss within rtol 1e-5, gradient within 2e-3 x max|g|
    (the two frames agree within the frame contract, not bit for bit).

    The reference's gradient is NaN wherever a wave meets total internal
    reflection (jnp.maximum under jnp.sqrt at wave/fresnel.py:101 passes
    0 * inf in reverse mode; ROADMAP.md section 3). With 2 reflections
    the refraction children meet it, some entries of the reference's
    gradient are NaN and those are compared nowhere; every entry of the
    port's gradient is finite. With 1 reflection no child is traced, and
    every entry is compared."""
    st, sa = room
    kw = dict(_CFG, n_reflections=n_reflections)
    cfg = RadarModelConfig(**kw)
    jcfg = JCFG.RadarModelConfig(**kw, trace_engine="pallas3",
                                 draw_method="pallas")
    poses = np.stack([make_pose([0.5, -0.3, 1.5]),
                      make_pose([-1.0, 2.0, 1.5], [0, 0, 0.2588, 0.9659])])
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(2)]
    draws = tuple(torch.from_numpy(np.stack(d)) for d in zip(
        *[_cone_draws(k, cfg) for k in keys]))
    jtrue, jstart = _jx_params(_TRUE, 10.0), _jx_params(_START, 7.0)
    targets = float_u8_image(simulate_frames(
        st, _port_params(jtrue), cfg, torch.from_numpy(poses),
        cone_draws=draws), cfg)
    jtargets = jnp.asarray(targets.numpy())

    def jx_loss(p):
        return jnp.mean(jnp.stack([-JM.psnr(jx_float_u8(jx_frame(
            sa, p, jcfg, jnp.asarray(poses[i]), keys[i]), jcfg),
            jtargets[i]) for i in range(2)]))

    jpv = JO.ParamVector(**_PV)
    to_vec, to_z = JO._sigmoid_reparam(jpv.bounds())
    z0 = to_z(jpv.to_vec(jstart))
    j_val, j_grad = jax.jit(jax.value_and_grad(
        lambda z: jx_loss(jpv.to_params(jstart, to_vec(z))[0])))(z0)

    pv = O.ParamVector(**_PV)
    objective = O.default_objective(st, cfg, torch.from_numpy(poses),
                                    targets, cone_draws=draws)
    step_loss, _, t_to_z = O.step_loss_fn(objective, _port_params(jstart),
                                          pv)
    z = t_to_z(pv.to_vec(_port_params(jstart)))
    np.testing.assert_allclose(z.numpy(), np.asarray(z0), rtol=1e-6)
    z.requires_grad_(True)
    val = step_loss(z)
    val.backward()
    g, jg = z.grad.numpy(), np.asarray(j_grad)
    assert -float(j_val) < 45.0           # the start is far from the truth
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    ok = np.isfinite(jg)
    assert ok.sum() >= (6 if n_reflections == 2 else pv.n)
    np.testing.assert_allclose(g[ok], jg[ok], rtol=0,
                               atol=2e-3 * np.abs(jg[ok]).max())


def test_gradient_opt_recovers_material(box_scene, simple_materials):
    """tests/test_opti.py:90-127 on the port: perturb one material, then
    recover it by Adam on the frame-difference loss."""
    parts = [box_scene.verts[box_scene.obj_ids == i] for i in range(2)]
    st = Scene.compose(parts, chunk_size=8).to_device("cpu")
    cfg = RadarModelConfig(n_angles=8, n_cells=64, n_samples=4,
                           n_reflections=1, resolution=0.5,
                           signal_denoising=0, ambient_noise=0)
    jtrue = JCFG.RadarParams.make(simple_materials, [1, 2],
                                  beam_width_deg=4.0)
    params_true = _port_params(jtrue)
    pose = torch.from_numpy(identity_pose())
    draws = sample_cone_draws(torch.Generator().manual_seed(0), 4, 2)
    target = simulate_frame(st, params_true, cfg, pose,
                            cone_draws=draws).image_float
    m = params_true.materials
    params_start = params_true._replace(materials=m._replace(
        ambient=m.ambient.index_put((torch.tensor([1]),),
                                    torch.tensor([0.4]))))
    pv = O.ParamVector(material_slots=(1,), tune_n_reflections=False,
                       tune_beam_width=False)

    def loss_of_params(p):
        res = simulate_frame(st, p, cfg, pose, cone_draws=draws)
        return torch.mean((res.image_float - target) ** 2)

    res = O.optimize_gradient(loss_of_params, params_start, pv, steps=40,
                              lr=0.1)
    start_loss = float(loss_of_params(params_start))
    assert res.value < start_loss * 0.2
    assert abs(float(res.params.materials.ambient[1]) - 1.0) < abs(0.4 - 1.0)
    assert len(res.history) == 40 and res.history[0] == pytest.approx(
        start_loss, rel=1e-6)


# ------------------------------------------------------------ checkpoints

def test_checkpoints_cross_packages(room, tmp_path):
    """A checkpoint of either package loads in the other and renders the
    same frame as the parameters it was written from."""
    st, sa = room
    kw = dict(_CFG, n_reflections=1, n_samples=3)
    cfg, jcfg = RadarModelConfig(**kw), JCFG.RadarModelConfig(**kw)
    pose = make_pose([0.5, -0.3, 1.5])
    key = jax.random.PRNGKey(4)
    jparams = _jx_params(_START, 9.0)
    draws = tuple(map(torch.from_numpy, _cone_draws(key, cfg)))

    JCK.save_checkpoint(tmp_path / "jx.npz", jparams, vec=np.arange(3.0),
                        history=[3.0, 2.0], step=7, meta={"lr": 0.08})
    params, extras = CK.load_checkpoint(tmp_path / "jx.npz")
    assert extras["step"] == 7 and float(extras["lr"]) == 0.08
    np.testing.assert_array_equal(extras["history"], [3.0, 2.0])
    ref = simulate_frame(st, _port_params(jparams), cfg,
                         torch.from_numpy(pose), cone_draws=draws)
    got = simulate_frame(st, params, cfg, torch.from_numpy(pose),
                         cone_draws=draws)
    assert torch.equal(got.image_u8, ref.image_u8) and got.image_u8.any()

    CK.save_checkpoint(tmp_path / "port.npz", params, vec=torch.ones(3),
                       step=9)
    jback, jextras = JCK.load_checkpoint(tmp_path / "port.npz")
    assert jextras["step"] == 9
    np.testing.assert_array_equal(jextras["vec"], np.ones(3, np.float32))
    a = simulate_frame_jit(sa, jparams, jcfg, jnp.asarray(pose), key)
    b = simulate_frame_jit(sa, jback, jcfg, jnp.asarray(pose), key)
    np.testing.assert_array_equal(np.asarray(a.image_u8),
                                  np.asarray(b.image_u8))
    assert not list(tmp_path.glob("*.tmp"))


# ------------------------------------------------------------ optimizers

def test_black_box_quadratic():
    target = np.array([0.3, -1.0, 2.0])
    bounds = np.array([[-2.0, 2.0], [-3.0, 3.0], [0.0, 4.0]])

    def f(x):
        return float(np.sum((x - target) ** 2))

    x, fx, hist = O.optimize_black_box(f, bounds, n_seeds=24, iters=80,
                                       seed=1)
    jx, jfx, jhist = JO.optimize_black_box(f, bounds, n_seeds=24, iters=80,
                                           seed=1)
    assert fx < 1e-3
    np.testing.assert_allclose(x, target, atol=0.05)
    np.testing.assert_array_equal(x, jx)
    assert hist == jhist


def test_sweep_n_reflections_keeps_best():
    """The outer sweep runs the inner fit per bounce count and keeps the
    best (a toy loss whose optimum depends on the count)."""
    params = _port_params(_jx_params(_START, 8.0))
    pv = O.ParamVector(material_slots=(1,), tune_beam_width=False,
                       tune_n_reflections=False)

    def make_loss(n_ref):
        def loss(p):
            return (p.materials.ambient[1] - 0.8) ** 2 + 0.1 * abs(n_ref - 3)
        return loss

    best = O.sweep_n_reflections(make_loss, params, pv,
                                 n_reflections_range=(1, 3, 4), steps=30,
                                 lr=0.1)
    assert best.n_reflections == 3 and best.value < 0.01
    assert best.params.materials.ambient.requires_grad is False


# ------------------------------------------------------------ workload

def test_radar_image_server(room):
    cfg = RadarModelConfig(**{**_CFG, "n_samples": 2})
    params = RadarParams.make(Materials.from_list(_TRUE), _OBJ,
                              beam_width_deg=4.0)
    server = RadarImageServer(Radar(Scene.compose(_parts(), chunk_size=8),
                                    params, cfg, device="cpu"))
    msg = server.get_radar_params()
    assert msg["model"]["beam_width"] == pytest.approx(4.0, abs=1e-4)
    assert len(msg["materials"]["data"]) == 3
    assert msg == params_to_msg(params, 2, cfg.n_reflections)
    img = server.gen_radar_image(pose=make_pose([0.5, -0.3, 1.5]))
    assert img.shape == (cfg.n_cells, cfg.n_angles) and img.dtype == np.uint8
    msg["materials"]["data"][1]["ambient"] = 0.5
    msg["model"]["n_samples"] = 3
    img2 = server.gen_radar_image(goal_params=msg)
    assert img2.shape == img.shape
    assert float(server.radar.params.materials.ambient[1]) == \
        pytest.approx(0.5)
    assert server.radar.cfg.n_samples == 3
