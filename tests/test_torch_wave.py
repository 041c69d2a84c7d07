"""The port's wave physics and transforms (radarays_ros_tpu_torch.wave,
.utils) against the JAX package: elementwise functions within rtol 1e-5 on
the same numpy inputs, cone distributions by their moments (torch and JAX
draw different random streams)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.utils import transforms as JT
from radarays_ros_tpu.wave import cone as JC
from radarays_ros_tpu.wave import fresnel as JF
from radarays_ros_tpu.wave import radar_math as JM
from radarays_ros_tpu.wave import types as JW

from radarays_ros_tpu_torch.utils import transforms as T
from radarays_ros_tpu_torch.wave import cone as C
from radarays_ros_tpu_torch.wave import fresnel as F
from radarays_ros_tpu_torch.wave import radar_math as M
from radarays_ros_tpu_torch.wave import types as W

torch.set_num_threads(2)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_erfinvf_matches_reference():
    a = np.concatenate([np.linspace(-0.999999, 0.999999, 2001),
                        [0.0, 0.8, -0.5, 1.0 - 1e-7]]).astype(np.float32)
    _close(M.erfinvf(torch.from_numpy(a)), JM.erfinvf(jnp.asarray(a)))


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("v1,v2", [(0.3, 0.0), (0.3, 0.15), (0.15, 0.3),
                                   (0.3, 0.3), ("mix", "mix")])
def test_fresnel_split_matches_reference(v1, v2):
    rng = np.random.default_rng(0)
    n = 512
    normal, d = _unit(rng, n), _unit(rng, n)
    energy = rng.uniform(0.1, 1.0, n).astype(np.float32)
    pol = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if v1 == "mix":
        v1 = rng.choice([0.0, 0.1, 0.3], n).astype(np.float32)
        v2 = rng.choice([0.0, 0.1, 0.3], n).astype(np.float32)
    else:
        v1 = np.full(n, v1, np.float32)
        v2 = np.full(n, v2, np.float32)
    got = F.fresnel_split(*map(torch.from_numpy, (normal, d, energy, pol,
                                                  v1, v2)))
    ref = JF.fresnel_split(*map(jnp.asarray, (normal, d, energy, pol,
                                              v1, v2)))
    for name in ("reflection_dir", "refraction_dir", "reflection_energy",
                 "refraction_energy", "incidence_angle"):
        _close(getattr(got, name), getattr(ref, name), rtol=1e-5, atol=2e-6)
    _close(F.get_incidence_angle(torch.from_numpy(normal),
                                 torch.from_numpy(d)),
           JF.get_incidence_angle(jnp.asarray(normal), jnp.asarray(d)))


def test_shaders_match_reference():
    rng = np.random.default_rng(1)
    ang = rng.uniform(0, np.pi, 400).astype(np.float32)
    e = rng.uniform(0, 1, 400).astype(np.float32)
    _close(F.back_reflection_shader(torch.from_numpy(ang), torch.from_numpy(e),
                                    1.0, 0.2, 300.0),
           JF.back_reflection_shader(jnp.asarray(ang), jnp.asarray(e),
                                     1.0, 0.2, 300.0))
    _close(F.cook_torrance_shader(torch.from_numpy(ang), torch.from_numpy(e),
                                  0.3, 0.1, 0.5),
           JF.cook_torrance_shader(jnp.asarray(ang), jnp.asarray(e),
                                   0.3, 0.1, 0.5), rtol=2e-5)


def test_waves_move_and_broadcast_match_reference():
    rng = np.random.default_rng(2)
    orig = rng.normal(size=(4, 1, 3)).astype(np.float32)
    d = _unit(rng, 24).reshape(4, 6, 3)
    attrs = dict(energy=1.0, polarization=0.5, velocity=0.3, material_id=0,
                 time=0.0)
    w = W.broadcast_waves(torch.from_numpy(orig), torch.from_numpy(d),
                          W.make_start_wave_attrs(), (4, 6))
    jw = JW.broadcast_waves(jnp.asarray(orig), jnp.asarray(d),
                            JW.make_start_wave_attrs(**attrs), (4, 6))
    dist = rng.uniform(0, 20, (4, 6)).astype(np.float32)
    got, ref = w.move(torch.from_numpy(dist)), jw.move(jnp.asarray(dist))
    for name in W.Waves._fields:
        _close(getattr(got, name).numpy().astype(np.float64),
               np.asarray(getattr(ref, name)).astype(np.float64))
    assert got.batch_shape == (4, 6) and got.material_id.dtype == torch.int32


def test_transforms_match_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    pose = np.concatenate([rng.normal(size=(5, 3)).astype(np.float32), q], 1)
    R, t = T.pose_matrix(torch.from_numpy(pose))
    jR, jt = JT.pose_matrix(jnp.asarray(pose))
    _close(R, jR)
    _close(t, jt)
    _close(T.azimuth_angles(400), JT.azimuth_angles(400))
    th = np.linspace(-3, 3, 7).astype(np.float32)
    _close(T.rotz(torch.from_numpy(th)), JT.rotz(jnp.asarray(th)))
    np.testing.assert_array_equal(T.make_pose([1, 2, 3]),
                                  JT.make_pose([1, 2, 3]))


@pytest.mark.parametrize("dist", [0, 1, 2, 3])
def test_cone_distributions_match_by_moments(dist):
    """Same distribution, different streams: the off-axis angle's mean and
    spread, and the azimuthal symmetry, agree within sampling error."""
    n = 20000
    width = np.float32(np.deg2rad(10.0))
    gen = torch.Generator().manual_seed(dist)
    got = C.sample_cone_local(gen, torch.tensor(width), n, dist, 0.8).numpy()
    ref = np.asarray(JC.sample_cone_local(jax.random.PRNGKey(dist),
                                          jnp.float32(width), n, dist, 0.8))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)

    def off_axis(v):
        return np.arccos(np.clip(v[:, 0], -1, 1))

    a, b = off_axis(got), off_axis(ref)
    se = b.std() / np.sqrt(n)
    assert abs(a.mean() - b.mean()) < 6 * se
    assert abs(a.std() - b.std()) < 0.05 * b.std()
    for comp in (1, 2):          # symmetric about the beam axis
        assert abs(got[:, comp].mean()) < 6 * got[:, comp].std() / np.sqrt(n)


def _jax_draws(key, n, dist):
    """The reference's own draws inside sample_cone_offsets
    (wave/cone.py:66-74): theta, then the radial draw."""
    k_angle, k_radius = jax.random.split(key)
    theta = jax.random.uniform(k_angle, (n,), jnp.float32, -jnp.pi, jnp.pi)
    radial = (jax.random.uniform(k_radius, (n,), jnp.float32) if dist < 2
              else jax.random.normal(k_radius, (n,), jnp.float32))
    return torch.from_numpy(np.array(theta)), torch.from_numpy(np.array(radial))


@pytest.mark.parametrize("dist", [0, 1, 2, 3])
def test_cone_from_reference_draws_matches_reference(dist):
    """Directions built from the reference's draws equal its sample_cone_*
    outputs, and their derivative w.r.t. the beam width is its gradient."""
    key = jax.random.PRNGKey(9)
    theta, radial = _jax_draws(key, 64, dist)
    mean = np.array([0.6, 0.0, 0.8], np.float32)
    _close(torch.stack(C.cone_offsets(theta, radial, 0.2, dist, 0.8)),
           jnp.stack(JC.sample_cone_offsets(key, 0.2, 64, dist, 0.8)))
    _close(C.cone_local(theta, radial, 0.2, dist, 0.8),
           JC.sample_cone_local(key, 0.2, 64, dist, 0.8))
    _close(C.cone_dirs(theta, radial, mean, 0.2, dist, 0.8),
           JC.sample_cone_dirs(key, mean, 0.2, 64, dist, 0.8))
    w = torch.tensor(0.2, requires_grad=True)
    C.cone_local(theta, radial, w, dist, 0.8)[:, 2].sum().backward()
    ref = jax.grad(lambda x: JC.sample_cone_local(key, x, 64, dist, 0.8)
                   [:, 2].sum())(jnp.float32(0.2))
    _close(w.grad, ref, rtol=1e-4, atol=1e-5)


def test_sample_cone_mean_and_generator_draws():
    """sample_cone_mean: the mean ray, then cone rays around it built from
    the generator's draws (the reference's layout, wave/cone.py:100-109);
    sample_cone_local is cone_local of sample_cone_draws."""
    mean = torch.tensor([0.0, 0.6, 0.8])
    g1 = torch.Generator().manual_seed(4)
    got = C.sample_cone_mean(g1, mean, 0.3, 9, 2, 0.8)
    g2 = torch.Generator().manual_seed(4)
    draws = C.sample_cone_draws(g2, 8, 2)
    assert got.shape == (9, 3)
    assert torch.equal(got[0], mean)
    assert torch.equal(got[1:], C.cone_dirs(*draws, mean, 0.3, 2, 0.8))
    cos = got[1:] @ mean
    assert (cos < 1.0).all() and (cos > np.cos(0.5)).all()
    g3 = torch.Generator().manual_seed(4)
    assert torch.equal(C.sample_cone_local(g3, 0.3, 8, 2, 0.8),
                       C.cone_local(*draws, 0.3, 2, 0.8))
    with pytest.raises(ValueError, match="sample_dist"):
        C.sample_cone_draws(g3, 8, 4)
