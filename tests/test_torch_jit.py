"""The port's compiled entries (radarays_ros_tpu_torch.sim.pipeline's
simulate_frame_jit / simulate_frames_jit, opti.optimize.value_and_grad)
on the CPU, where they run the eager code: bit-equal to the eager frame
and fit step, within the frame contract of tests/test_oracle.py:70-87 (and
the fit tolerance of tests/test_torch_opti.py) of the JAX package's jitted
counterparts, the generator draws in simulate_frames' order, the graph
cache's key, and a capture guard.

The guard (`CaptureGuard`, a TorchDispatchMode) runs a call twice: the
first learns the tensors the call reads from outside (its inputs and the
constants cached on first use, as the card's warm-up makes them); the
second fails on any op a CUDA graph cannot hold — a host sync
(aten._local_scalar_dense, is_nonzero, nonzero, a boolean index), a tensor
made from host data (aten.lift_fresh), or a tensor the call reads that no
op of it made and the first call did not read (a fresh copy of host data)
— outside the kernel wrappers' plain versions, which run only on the CPU.
So a new per-call host constant fails here before the card sees it.
Small sizes (16 azimuths, 128 cells, 6 samples, 8-triangle chunks).
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax
import jax.numpy as jnp

from radarays_ros_tpu.geom.scene import Scene as JxScene
from radarays_ros_tpu.opti import metrics as JM
from radarays_ros_tpu.opti import optimize as JO
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.sim.pipeline import float_u8_image as jx_float_u8
from radarays_ros_tpu.sim.pipeline import simulate_frame as jx_frame
from radarays_ros_tpu.sim.pipeline import (simulate_frame_jit as jx_jit,
                                           simulate_frames_jit as jx_jits)
from radarays_ros_tpu.wave.cone import sample_cone_local as jx_cone

from radarays_ros_tpu_torch.geom.primitives import make_box
from radarays_ros_tpu_torch.geom.scene import Scene, with_planes
from radarays_ros_tpu_torch.image import cuda_draw, perlin
from radarays_ros_tpu_torch.opti import optimize as O
from radarays_ros_tpu_torch.sim import graphs as G
from radarays_ros_tpu_torch.sim import lookup
from radarays_ros_tpu_torch.sim import pipeline as P
from radarays_ros_tpu_torch.sim.config import (RadarModelConfig,
                                               params_from_numpy)
from radarays_ros_tpu_torch.trace import cuda_trace as CT
from radarays_ros_tpu_torch.utils.transforms import make_pose
from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

torch.set_num_threads(2)

_MATS = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),    # air
         dict(velocity=0.0, ambient=0.9, diffuse=0.1, specular=200.0),  # wall
         dict(velocity=0.0, ambient=0.5, diffuse=0.4, specular=60.0)]   # stone
# the pillar and the slab transmit (velocity > 0): refraction children live
_MATS_T = [_MATS[0], _MATS[1],
           dict(velocity=0.12, ambient=0.5, diffuse=0.4, specular=60.0)]
_OBJ_MATS = [1, 2, 2]
_CFG = dict(n_angles=16, n_cells=128, resolution=0.25, n_samples=6,
            beam_sample_dist=2, n_reflections=3, record_multi_reflection=True,
            signal_denoising=1, signal_denoising_triangular_width=7,
            signal_denoising_triangular_mode=0.4, ambient_noise=2,
            ambient_noise_at_signal_0=0.2, ambient_noise_at_signal_1=0.05,
            ambient_noise_energy_max=0.3, ambient_noise_energy_min=0.1,
            scroll_image=5, opaque_materials=True, trace_ray_block=128,
            trace_engine="kernel")
# the fit's physics (benchmarks/opti_scale.py:84-92) at a small size, as
# tests/test_torch_opti.py
_FIT = dict(n_angles=16, n_cells=128, resolution=0.25, n_samples=6,
            beam_sample_dist=2, n_reflections=1, energy_max=0.72,
            signal_max=110.0, signal_denoising=1,
            signal_denoising_triangular_width=7,
            signal_denoising_triangular_mode=0.35, ambient_noise=0,
            record_multi_reflection=True, opaque_materials=False,
            trace_ray_block=128, trace_engine="kernel")
_TRUE = [_MATS[0],
         dict(velocity=0.0, ambient=0.85, diffuse=0.15, specular=900.0),
         dict(velocity=0.1, ambient=0.35, diffuse=0.6, specular=150.0)]
_START = [_MATS[0],
          dict(velocity=0.05, ambient=0.3, diffuse=0.6, specular=150.0),
          dict(velocity=0.2, ambient=0.9, diffuse=0.05, specular=2000.0)]
_PV = dict(material_slots=(1, 2), tune_beam_width=True,
           tune_n_reflections=False)
_POSES = np.stack([make_pose([0.5, -0.3, 1.0]),
                   make_pose([-1.0, 2.0, 1.5], [0, 0, 0.2588, 0.9659])])


def _parts():
    # closed room (normals inward via reversed winding) + two pillars
    return [make_box((0, 0, 0), (40.0, 40.0, 10.0))[:, ::-1, :],
            make_box((8.0, 2.0, 0.0), (2.0, 2.0, 10.0)),
            make_box((-6.0, -7.0, 0.0), (4.0, 1.0, 10.0))]


def _both_params(mats, deg=15.0):
    """The reference's RadarParams for `mats` and the port's copy."""
    jparams = JCFG.RadarParams.make(JCFG.Materials.from_list(mats),
                                    _OBJ_MATS, beam_width_deg=deg)
    m = jparams.materials
    return jparams, params_from_numpy(*(np.asarray(x) for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        jparams.object_materials, jparams.beam_width)))


@pytest.fixture(scope="module")
def world():
    parts = _parts()
    st = Scene.compose(parts, ["walls", "pillar", "slab"],
                       chunk_size=8).to_device("cpu")
    sa = JxScene.compose(parts, chunk_size=8).device_arrays(cache=False)
    return st, sa


def _inputs(key, cfg, beam_width):
    """The reference frame's own cone and Perlin draws for `key`."""
    k_cone, k_noise = jax.random.split(key)
    dirs = np.array(jx_cone(k_cone, beam_width, cfg.n_samples,
                            cfg.beam_sample_dist,
                            cfg.beam_sample_dist_normal_p_in_cone))
    k_begin, _ = jax.random.split(k_noise)
    begin = np.array(jax.random.randint(k_begin, (cfg.n_angles,), 0, 1000))
    return dirs, begin


def _frame_contract(got, ref):
    """tests/test_oracle.py:70-87: image_float within atol 2e-4*max and
    rtol 2e-3, max_val within rtol 1e-4, u8 within 1 on >= 99.5% of pixels
    and never more than 3 apart."""
    o_img = np.asarray(ref.image_float, np.float64)
    assert o_img.max() > 0, "reference frame is empty"
    np.testing.assert_allclose(got.image_float.double().numpy(), o_img,
                               atol=2e-4 * o_img.max(), rtol=2e-3)
    np.testing.assert_allclose(got.max_val.double().numpy(),
                               np.asarray(ref.max_val, np.float64),
                               rtol=1e-4, atol=1e-6)
    diff = np.abs(got.image_u8.numpy().astype(int)
                  - np.asarray(ref.image_u8).astype(int))
    assert (diff <= 1).mean() >= 0.995 and diff.max() <= 3


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------- against the eager frame

@pytest.mark.parametrize("inputs", ["draws", "local_dirs", "generator",
                                    "uniform"])
def test_frames_jit_equal_eager_frames(world, inputs):
    """simulate_frames_jit and simulate_frame_jit are the eager frames bit
    for bit on the CPU, on explicit inputs and on generator draws."""
    st, _ = world
    _, params = _both_params(_MATS)
    cfg = RadarModelConfig(**_CFG)
    poses = torch.from_numpy(_POSES)
    g = torch.Generator().manual_seed(4)
    kw = {}
    if inputs == "draws":
        kw = dict(cone_draws=tuple(torch.stack(d) for d in zip(*[
            sample_cone_draws(g, 6, 2) for _ in range(2)])),
            random_begin=torch.randint(0, 1000, (2, 16), generator=g))
    elif inputs == "local_dirs":
        kw = dict(local_dirs=torch.randn(6, 3, generator=g) * 0.01
                  + torch.tensor([1.0, 0.0, 0.0]),
                  random_begin=torch.randint(0, 1000, (2, 16), generator=g))
    elif inputs == "uniform":
        cfg = cfg.replace(ambient_noise=1)
        kw = dict(cone_draws=tuple(torch.stack(d) for d in zip(*[
            sample_cone_draws(g, 6, 2) for _ in range(2)])),
            uniform=torch.rand((2, 16, 128), generator=g))

    def run(frames, **extra):
        return frames(st, params, cfg, poses, **kw, **extra)

    if inputs == "generator":
        want = run(P.simulate_frames,
                   generator=torch.Generator().manual_seed(9))
        got = run(P.simulate_frames_jit,
                  generator=torch.Generator().manual_seed(9))
    else:
        want, got = run(P.simulate_frames), run(P.simulate_frames_jit)
    assert want.image_u8.shape == (2, 128, 16) and want.image_u8.max() > 0
    assert _equal(got, want)
    assert not got.image_float.requires_grad

    one = {k: (tuple(x[0] for x in v) if isinstance(v, tuple) else
               v if k == "local_dirs" else v[0]) for k, v in kw.items()}
    gen = ({} if inputs != "generator" else
           dict(generator=torch.Generator().manual_seed(9)))
    want1 = P.simulate_frame(st, params, cfg, poses[0], **one, **gen)
    gen = ({} if inputs != "generator" else
           dict(generator=torch.Generator().manual_seed(9)))
    got1 = P.simulate_frame_jit(st, params, cfg, poses[0], **one, **gen)
    assert got1.image_u8.shape == (128, 16) and _equal(got1, want1)


@pytest.mark.parametrize("batch", [2, 1])
def test_frames_jit_on_cpu_counts_no_host_fetch(world, batch):
    """On the CPU the compiled entry is the eager frame: every field bit
    for bit, the u8 image an ordinary CPU tensor (not page-locked), and no
    page-locked fetch counted (the card's compiled entries fetch their u8
    images to the host; the CPU's are there already)."""
    st, _ = world
    _, params = _both_params(_MATS)
    cfg = RadarModelConfig(**_CFG)
    poses = torch.from_numpy(_POSES[:batch])
    n0 = (P.simulate_frames_jit.host_fetches,
          P.simulate_frames_jit.host_fetch_bytes)

    def run(frames, frame):
        g = torch.Generator().manual_seed(3)
        if batch > 1:
            return frames(st, params, cfg, poses, generator=g)
        return frame(st, params, cfg, poses[0], generator=g)

    want = run(P.simulate_frames, P.simulate_frame)
    got = run(P.simulate_frames_jit, P.simulate_frame_jit)
    assert got.image_u8.max() > 0 and _equal(got, want)
    assert got.image_u8.device.type == "cpu"
    assert not got.image_u8.is_pinned()
    assert (P.simulate_frames_jit.host_fetches,
            P.simulate_frames_jit.host_fetch_bytes) == n0


def test_generator_draw_order_matches_simulate_frames(world):
    """Absent random inputs are drawn in simulate_frames' order (the cone
    draws frame by frame, then the Perlin offsets): one seed gives the same
    batch, and leaves both generators in the same state."""
    st, _ = world
    _, params = _both_params(_MATS)
    cfg = RadarModelConfig(**_CFG)
    poses = torch.from_numpy(_POSES)
    ga, gb = torch.Generator().manual_seed(21), torch.Generator().manual_seed(21)
    want = P.simulate_frames(st, params, cfg, poses, generator=ga)
    got = P.simulate_frames_jit(st, params, cfg, poses, generator=gb)
    assert _equal(got, want)
    assert torch.equal(ga.get_state(), gb.get_state())
    # the draws, written out: theta then radial a frame, then the offsets
    g = torch.Generator().manual_seed(21)
    draws = [sample_cone_draws(g, cfg.n_samples, cfg.beam_sample_dist)
             for _ in range(2)]
    begin = torch.randint(0, 1000, (2, cfg.n_angles), generator=g)
    explicit = P.simulate_frames(
        st, params, cfg, poses,
        cone_draws=tuple(torch.stack(d) for d in zip(*draws)),
        random_begin=begin)
    assert _equal(explicit, want)


# --------------------------------------- against the JAX package's jits

@pytest.mark.parametrize("opaque", [True, False])
def test_frame_jit_matches_reference_jit(world, opaque):
    """simulate_frame_jit against the reference's simulate_frame_jit on its
    own cone directions and Perlin offsets, under the frame contract (the
    reference runs its Pallas kernels in interpret mode)."""
    st, sa = world
    jparams, params = _both_params(_MATS if opaque else _MATS_T)
    kw = dict(opaque_materials=opaque)
    cfg = RadarModelConfig(**{**_CFG, **kw})
    jcfg = JCFG.RadarModelConfig(**{**_CFG, **kw, "trace_engine": "pallas3",
                                    "draw_method": "pallas"})
    pose = _POSES[0]
    key = jax.random.PRNGKey(3)
    ref = jx_jit(sa, jparams, jcfg, jnp.asarray(pose),
                 tuple(jax.random.split(key)))
    dirs, begin = _inputs(key, cfg, jparams.beam_width)
    got = P.simulate_frame_jit(st, params, cfg, torch.from_numpy(pose),
                               local_dirs=torch.from_numpy(dirs),
                               random_begin=torch.from_numpy(begin))
    assert got.image_u8.shape == (cfg.n_cells, cfg.n_angles)
    _frame_contract(got, ref)


def test_frames_jit_matches_reference_jit(world):
    """simulate_frames_jit against the reference's simulate_frames_jit on a
    two-frame batch, each frame under the frame contract."""
    st, sa = world
    jparams, params = _both_params(_MATS)
    cfg = RadarModelConfig(**_CFG)
    jcfg = JCFG.RadarModelConfig(**{**_CFG, "trace_engine": "pallas3",
                                    "draw_method": "pallas"})
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    ref = jx_jits(sa, jparams, jcfg, jnp.asarray(_POSES), keys)
    ins = [_inputs(k, cfg, jparams.beam_width) for k in keys]
    got = P.simulate_frames_jit(
        st, params, cfg, torch.from_numpy(_POSES),
        local_dirs=torch.from_numpy(np.stack([i[0] for i in ins])),
        random_begin=torch.from_numpy(np.stack([i[1] for i in ins])))
    assert got.image_u8.shape == (2, cfg.n_cells, cfg.n_angles)
    for n in range(2):
        _frame_contract(type(got)(*(x[n] for x in got)),
                        type(ref)(*(x[n] for x in ref)))


# ---------------------------------------------------------- the graph key

def _args(params, poses, draws, begin):
    return P._frame_args(params, poses, None, draws, begin, None)


def _key(scene, cfg, args):
    return P.frame_graphs.key(args, static=(scene, cfg))


def test_frame_key_is_a_pure_function_of_shapes(world):
    """The frame graph's key: the same key for new pose, draw and param
    values; a new key for a new cfg, batch size N, pose shape or scene."""
    st, _ = world
    _, params = _both_params(_MATS)
    _, params2 = _both_params(_MATS_T, deg=9.0)
    cfg = RadarModelConfig(**_CFG)
    g = torch.Generator().manual_seed(0)

    def args(p=params, N=2, per_azimuth=False, seed=None):
        gen = g if seed is None else torch.Generator().manual_seed(seed)
        shape = (N, 16, 7) if per_azimuth else (N, 7)
        draws = (torch.rand(N, 6, generator=gen),
                 torch.randn(N, 6, generator=gen))
        return _args(p, torch.rand(shape, generator=gen), draws,
                     torch.randint(0, 1000, (N, 16), generator=gen))

    key = _key(st, cfg, args())
    assert _key(st, cfg, args()) == key
    assert hash(_key(st, cfg, args(seed=5))) == hash(key)
    assert _key(st, cfg, args(p=params2)) == key
    assert _key(st._replace(), cfg, args()) == key   # same tensors
    assert _key(st, cfg.replace(n_reflections=2), args()) != key
    assert _key(st, cfg, args(N=3)) != key
    assert _key(st, cfg, args(per_azimuth=True)) != key
    other = st._replace(fetch=st.fetch.clone())
    assert _key(other, cfg, args()) != key
    # explicit directions take another graph than cone draws
    dirs = P._frame_args(params, torch.rand(2, 7), torch.rand(6, 3), None,
                         torch.randint(0, 1000, (2, 16)), None)
    assert _key(st, cfg, dirs) != key


def test_frame_key_holds_the_scene(world):
    """A key names the scene's tensors by identity and holds them: a scene
    that a cached graph reads in place is not freed while the key lives,
    so its id cannot come back for another scene of the same shapes (as
    Radar.load_materials bakes a new scene each time)."""
    st, _ = world
    _, params = _both_params(_MATS)
    cfg = RadarModelConfig(**_CFG)
    baked = st._replace(fetch=st.fetch.clone())
    fetch = weakref.ref(baked.fetch)
    key = _key(baked, cfg, _args(params, torch.zeros(2, 7), None, None))
    del baked
    gc.collect()
    assert fetch() is not None
    del key
    gc.collect()
    assert fetch() is None


def test_flatten_round_trip(world):
    """The argument trees of the graphs (NamedTuples, tuples, None,
    values) flatten to their tensors and back."""
    _, params = _both_params(_MATS)
    tree = (params, torch.zeros(2, 7), None, (torch.ones(3), 4), "x")
    leaves, spec = G.flatten(tree)
    assert len(leaves) == 6 + 2 and hash(spec) == hash(G.flatten(tree)[1])
    back = G.unflatten(spec, leaves)
    assert type(back[0]) is type(params) and back[2] is None
    assert back[3][1] == 4 and back[4] == "x"
    assert torch.equal(back[0].materials.specular, params.materials.specular)


def test_refused_configs_pick_the_eager_entry():
    """The plain "sweep" engine is refused on the card, by the config and
    before anything runs; frames_entry then hands the eager frame, saying
    so once a call site; on the CPU every config takes the compiled entry
    (eager there)."""
    cfg = RadarModelConfig(**_CFG)
    assert P.jit_refusal(cfg) is None
    assert "sweep" in P.jit_refusal(cfg.replace(trace_engine="sweep"))
    assert P.frames_entry(cfg, "cuda") is P.simulate_frames_jit
    assert P.frames_entry(cfg, "cuda", batched=False) is P.simulate_frame_jit
    with pytest.warns(UserWarning, match="sweep"):
        f = P.frames_entry(cfg.replace(trace_engine="sweep"), "cuda")
    assert f is P.simulate_frames
    assert P.frames_entry(cfg.replace(trace_engine="sweep"),
                          "cpu") is P.simulate_frames_jit
    # outside a layout the scene axis names no group: not refused
    assert P.jit_refusal(cfg.replace(trace_scene_axis="scene")) is None


# ------------------------------------------------------------ the fit

def _fit(world):
    st, sa = world
    cfg = RadarModelConfig(**_FIT)
    jcfg = JCFG.RadarModelConfig(**{**_FIT, "trace_engine": "pallas3",
                                    "draw_method": "pallas"})
    poses = _POSES.astype(np.float32).copy()
    poses[:, 2] = 1.5
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(2)]

    def cone(key):
        k_cone, _ = jax.random.split(key)
        k_angle, k_radius = jax.random.split(k_cone)
        return (np.array(jax.random.uniform(k_angle, (6,), jnp.float32,
                                            -jnp.pi, jnp.pi)),
                np.array(jax.random.normal(k_radius, (6,), jnp.float32)))

    draws = tuple(torch.from_numpy(np.stack(d))
                  for d in zip(*[cone(k) for k in keys]))
    jtrue, true = _both_params(_TRUE, 10.0)
    jstart, start = _both_params(_START, 7.0)
    targets = P.float_u8_image(P.simulate_frames(
        st, true, cfg, torch.from_numpy(poses), cone_draws=draws), cfg)
    obj = O.default_objective(st, cfg, torch.from_numpy(poses), targets,
                              cone_draws=draws)
    pv = O.ParamVector(**_PV)
    step_loss, _, to_z = O.step_loss_fn(obj, start, pv)
    return dict(st=st, sa=sa, cfg=cfg, jcfg=jcfg, poses=poses, keys=keys,
                targets=targets, jstart=jstart, start=start, pv=pv,
                step_loss=step_loss, z=to_z(pv.to_vec(start)))


def test_value_and_grad_equals_eager_and_reference(world):
    """The compiled value-and-grad of the fit's step loss is the eager loss
    and gradient bit for bit on the CPU, over three Adam steps, and the
    reference's jax.jit(jax.value_and_grad(step_loss)) within the fit
    tolerance of tests/test_torch_opti.py (loss rtol 1e-5, gradient within
    2e-3 x max|g|)."""
    f = _fit(world)
    grad_fn = O.value_and_grad(f["step_loss"])
    z_c = f["z"].clone().requires_grad_(True)
    z_e = f["z"].clone().requires_grad_(True)
    opt_c = torch.optim.Adam([z_c], lr=0.05)
    opt_e = torch.optim.Adam([z_e], lr=0.05)
    for step in range(3):
        val, g = grad_fn(z_c)
        opt_e.zero_grad()
        loss = f["step_loss"](z_e)
        loss.backward()
        assert torch.equal(val, loss.detach()) and torch.equal(g, z_e.grad)
        assert not val.requires_grad and not g.requires_grad
        if step == 0:
            first = (val.item(), g.numpy().copy())
        z_c.grad = g
        opt_c.step()
        opt_e.step()
        assert torch.equal(z_c, z_e)

    jpv = JO.ParamVector(**_PV)
    to_vec, to_z = JO._sigmoid_reparam(jpv.bounds())
    jtargets = jnp.asarray(f["targets"].numpy())

    def jx_loss(p):
        return jnp.mean(jnp.stack([-JM.psnr(jx_float_u8(jx_frame(
            f["sa"], p, f["jcfg"], jnp.asarray(f["poses"][i]), f["keys"][i]),
            f["jcfg"]), jtargets[i]) for i in range(2)]))

    j_val, j_grad = jax.jit(jax.value_and_grad(
        lambda z: jx_loss(jpv.to_params(f["jstart"], to_vec(z))[0])))(
        to_z(jpv.to_vec(f["jstart"])))
    jg = np.asarray(j_grad)
    assert np.isfinite(jg).all()
    np.testing.assert_allclose(first[0], float(j_val), rtol=1e-5)
    np.testing.assert_allclose(first[1], jg, rtol=0,
                               atol=2e-3 * np.abs(jg).max())


def test_optimize_gradient_refuses_tuned_bounce_count():
    """tune_n_reflections reads the bounce count on the host in every loss:
    the compiled step refuses it, as the reference's jit cannot trace it."""
    _, params = _both_params(_MATS)
    with pytest.raises(ValueError, match="tune_n_reflections"):
        O.optimize_gradient(lambda p: p.beam_width, params,
                            O.ParamVector(material_slots=(1,)), steps=1)


def test_compiled_loss_equals_eager(world):
    """opti.optimize.compiled (the reference's jax.jit(loss_of_params), as
    the CLI's optimize and opti_scale use it) is the eager loss on the
    CPU, without autograd."""
    f = _fit(world)
    obj = O.default_objective(f["st"], f["cfg"], torch.from_numpy(f["poses"]),
                              f["targets"], cone_draws=(torch.zeros(2, 6),
                                                        torch.ones(2, 6)))
    got = O.compiled(obj)(f["start"])
    with torch.no_grad():
        want = obj(f["start"])
    assert torch.equal(got, want) and not got.requires_grad


# ------------------------------------------------------------ the guard

aten = torch.ops.aten
_SYNCS = {aten._local_scalar_dense, aten.is_nonzero, aten.nonzero,
          aten.masked_select, aten.item, aten.equal, aten.lift_fresh,
          aten.lift_fresh_copy, aten.unique_consecutive, aten._unique2}
# the kernels' plain versions: on the card the wrappers launch kernels
_PLAIN = ((CT, "_sweep_plain"), (CT, "_prep_plain"),
          (CT, "_coarse_words_plain"), (cuda_draw, "_bin_plain"),
          (cuda_draw, "_bin_bwd"), (lookup, "_table_grad_plain"))


def _ptr(t):
    return t.untyped_storage().data_ptr() if t.numel() else None


class CaptureGuard(TorchDispatchMode):
    """Records the ops of a call (module doc). learned=None: the first
    call, which learns the storages it reads from outside; else the
    second, which lists every op a capture could not hold in
    `violations`."""

    def __init__(self, learned=None):
        super().__init__()
        self.learned = learned
        self.made = set()           # storages the call's ops made
        self.outside = {}           # storage -> tensor, read from outside
        self.outputs = []           # (weakref, storage) of every output
        self.violations = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        if not self.paused:
            for t in tensors:
                p = _ptr(t)
                if p is None or p in self.made:
                    continue
                if self.learned is None:
                    self.outside[p] = t
                elif p not in self.learned:
                    self.violations.append(
                        f"{func}: reads a tensor {tuple(t.shape)} made "
                        "outside the call (host data?)")
            if self.learned is not None:
                if func.overloadpacket in _SYNCS:
                    self.violations.append(f"{func}")
                if func.overloadpacket in (aten.index, aten.index_put,
                                           aten.index_put_) and any(
                        t is not None and t.dtype == torch.bool
                        for t in (args[1] if len(args) > 1 else ())):
                    self.violations.append(f"{func} with a boolean index")
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and _ptr(t) is not None:
                self.made.add(_ptr(t))
                self.outputs.append((weakref.ref(t), _ptr(t)))
        return out

    def learned_next(self) -> set:
        """What a second call may read from outside: this call's outside
        reads and its outputs still alive (the caches it filled)."""
        return set(self.outside) | {p for r, p in self.outputs
                                    if r() is not None}


def _guarded(monkeypatch, fn):
    """fn() twice under the guard, the plain versions paused; returns the
    second call's violations."""
    guards = []

    def pause(f):
        def run(*a, **k):
            guards[-1].paused += 1
            try:
                return f(*a, **k)
            finally:
                guards[-1].paused -= 1
        return run

    for mod, name in _PLAIN:
        monkeypatch.setattr(mod, name, pause(getattr(mod, name)))
    with CaptureGuard() as g1:
        guards.append(g1)
        fn()
    with CaptureGuard(g1.learned_next()) as g2:
        guards.append(g2)
        fn()
    return g2.violations


def _frame_call(world, cfg_kw, engine):
    st, _ = world
    mats = _MATS if cfg_kw.get("opaque_materials", True) else _MATS_T
    _, params = _both_params(mats)
    cfg = RadarModelConfig(**{**_CFG, **cfg_kw, "trace_engine": engine})
    if engine == "mxu":
        st = with_planes(st)
    poses = torch.from_numpy(_POSES)
    gen = torch.Generator().manual_seed(1)
    return lambda: P.simulate_frames(st, params, cfg, poses, generator=gen)


@pytest.mark.parametrize("engine,cfg_kw", [
    ("kernel", {}),
    ("kernel", dict(opaque_materials=False, record_multi_path=True,
                    ambient_noise=1, trace_two_phase_cap=5.0)),
    ("mxu", {}), ("brute", {})])
def test_capture_guard_frame(world, monkeypatch, engine, cfg_kw):
    """One eager frame batch holds no op a CUDA graph cannot capture
    (outside the kernels' plain versions): no host sync, no host data made
    a call."""
    assert _guarded(monkeypatch, _frame_call(world, cfg_kw, engine)) == []


def test_capture_guard_fit_step(world, monkeypatch):
    """One fit step's forward and backward (the compiled value-and-grad's
    body) holds no op a CUDA graph cannot capture."""
    f = _fit(world)
    grad_fn = O.value_and_grad(f["step_loss"])
    z = f["z"].clone()
    assert _guarded(monkeypatch, lambda: grad_fn(z)) == []


def test_capture_guard_positive_controls(world, monkeypatch):
    """The guard fails on what a capture cannot hold: a host sync (.item()
    in the binning's glue), a constant made from host data every call
    (as_tensor of a Python float), and a fresh copy of a host table every
    call (torch.from_numpy, which no op makes)."""
    frame = _frame_call(world, {}, "kernel")
    draw = P.draw_signals

    def synced(*a, **k):
        img, mv = draw(*a, **k)
        mv.max().item()
        return img, mv

    monkeypatch.setattr(P, "draw_signals", synced)
    assert any("_local_scalar_dense" in v
               for v in _guarded(monkeypatch, frame))
    monkeypatch.setattr(P, "draw_signals", draw)

    move = P.Waves.move

    def host_constant(self, distance):
        if not torch.is_tensor(distance):
            distance = torch.as_tensor(distance, dtype=torch.float32)
        return move(self, distance)

    monkeypatch.setattr(P.Waves, "move", host_constant)
    assert any("lift_fresh" in v for v in _guarded(monkeypatch, frame))
    monkeypatch.setattr(P.Waves, "move", move)

    monkeypatch.setattr(perlin, "_on_device",
                        lambda name, device: torch.from_numpy(
                            np.array(getattr(perlin, name))))
    assert any("made outside the call" in v
               for v in _guarded(monkeypatch, frame))
