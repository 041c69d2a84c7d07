"""The bench twins (radarays_ros_tpu_torch/bench/) against the JAX repo's
own harnesses at small sizes on the CPU: bench.py's preset and scene
build, its exactness gate and frame, benchmarks/opti_scale.py's objective
and the order/chunk-size proxies of benchmarks/order_ab.py and
chunksize_ab.py. The harnesses are imported here, never from the port.

The port runs its kernels' plain versions (`--device cpu`); the reference
runs its Pallas kernels in interpret mode.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu_torch.bench import common as C
from radarays_ros_tpu_torch.bench import headline as H
from radarays_ros_tpu_torch.bench import opti_scale as OS
from radarays_ros_tpu_torch.bench import order_ab as OA
from radarays_ros_tpu_torch.sim.config import (RadarModelConfig,
                                               port_draw_method, port_engine)
from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
from radarays_ros_tpu_torch.utils.transforms import make_pose

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# a small frame of the KAIST preset's physics
SMALL = dict(n_angles=16, n_cells=256, resolution=0.25, n_samples=4,
             trace_ray_block=128)


def _load(name: str):
    """A module of the repository root or of benchmarks/, by path (the
    harnesses import each other as top-level modules)."""
    path = ROOT / f"{name}.py"
    if not path.exists():
        path = ROOT / "benchmarks" / f"{name}.py"
    for d in (ROOT, ROOT / "benchmarks"):
        if str(d) not in sys.path:
            sys.path.append(str(d))
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_bench():
    return _load("bench")


def test_build_benchmark_matches_reference(ref_bench):
    sa, jparams, jcfg, _ = ref_bench.build_benchmark(200)
    b = C.build_benchmark(200, device="cpu")
    for f in dataclasses.fields(RadarModelConfig):
        want = getattr(jcfg, f.name)
        if f.name == "trace_engine":
            want = port_engine(want)
        elif f.name == "draw_method":
            want = port_draw_method(want)
        assert getattr(b.cfg, f.name) == want, f.name
    m, jm = b.params.materials, jparams.materials
    for a, w in zip(m, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    np.testing.assert_array_equal(b.params.object_materials.numpy(),
                                  np.asarray(jparams.object_materials))
    assert float(b.params.beam_width) == float(jparams.beam_width)
    h = b.host
    for mine, theirs in ((h.verts, sa.verts), (h.obj_ids, sa.obj_ids),
                         (h.normals, sa.normals), (h.planes_o, sa.planes_o),
                         (h.chunk_lo, sa.chunk_aabb_lo),
                         (h.chunk_hi, sa.chunk_aabb_hi)):
        theirs = np.asarray(theirs)
        assert mine.dtype == theirs.dtype
        assert mine.tobytes() == theirs.tobytes()
    # the baked material map: wall-stone (1) on every real triangle
    assert b.scene.n_triangles == sa.verts.shape[0]
    assert h.chunk_size == sa.chunk_size == 256


def test_parity_check_matches_reference(ref_bench):
    got = H.parity_check(n_buildings=40, n_rays=4000, device="cpu")
    want = ref_bench.parity_check(n_buildings=40, n_rays=4000)
    assert list(got) == list(want)
    assert got["exact"] is True and want["exact"] is True
    for k in ("n_triangles", "n_rays", "hit_rate", "hit_mismatches"):
        assert got[k] == want[k], k


def test_twin_frame_matches_reference_frame(ref_bench):
    """One frame of the twin's benchmark from the reference frame's own
    random inputs, within the frame contract of tests/test_oracle.py:70-87
    against the JAX simulate_frame_jit on the reference's benchmark."""
    from radarays_ros_tpu.sim.pipeline import simulate_frame_jit
    from radarays_ros_tpu.wave.cone import sample_cone_local as jx_cone

    sa, jparams, jcfg, key = ref_bench.build_benchmark(
        120, extent=60.0, cfg_overrides=SMALL)
    b = C.build_benchmark(120, 60.0, cfg_overrides=SMALL, device="cpu")
    pose = make_pose([0.5, -0.3, 2.0])
    ref = simulate_frame_jit(sa, jparams, jcfg, jnp.asarray(pose),
                             tuple(jax.random.split(key)))
    k_cone, k_noise = jax.random.split(key)
    dirs = np.array(jx_cone(k_cone, jparams.beam_width, jcfg.n_samples,
                            jcfg.beam_sample_dist,
                            jcfg.beam_sample_dist_normal_p_in_cone))
    begin = np.array(jax.random.randint(jax.random.split(k_noise)[0],
                                        (jcfg.n_angles,), 0, 1000))
    got = simulate_frame(b.scene, b.params, b.cfg, torch.from_numpy(pose),
                         local_dirs=torch.from_numpy(dirs),
                         random_begin=torch.from_numpy(begin))
    o_img = np.asarray(ref.image_float, np.float64)
    assert o_img.max() > 0
    np.testing.assert_allclose(got.image_float.double().numpy(), o_img,
                               atol=2e-4 * o_img.max(), rtol=2e-3)
    np.testing.assert_allclose(got.max_val.double().numpy(),
                               np.asarray(ref.max_val, np.float64),
                               rtol=1e-4, atol=1e-6)
    diff = np.abs(got.image_u8.numpy().astype(int)
                  - np.asarray(ref.image_u8).astype(int))
    assert (diff <= 1).mean() >= 0.995 and diff.max() <= 3


# ------------------------------------------------------------ opti_scale

_FIT = dict(n_angles=16, n_cells=128, n_samples=4, trace_ray_block=128)


def _jax_fit_loss(n_buildings, n_frames, extent):
    """benchmarks/opti_scale.py's objective at the start parameters, at a
    small size: (its loss, the cone draws of its frames)."""
    from radarays_ros_tpu.geom.primitives import make_urban_scene
    from radarays_ros_tpu.geom.scene import Scene
    from radarays_ros_tpu.io.trajectory import Trajectory
    from radarays_ros_tpu.opti.metrics import psnr
    from radarays_ros_tpu.sim.config import (Materials, RadarModelConfig as
                                             JCfg, RadarParams)
    from radarays_ros_tpu.sim.pipeline import (float_u8_image,
                                               simulate_frame,
                                               simulate_frame_jit)

    parts, names = make_urban_scene(n_buildings=n_buildings, extent=extent,
                                    seed=11)
    sa = Scene.compose(parts, names, chunk_size=256).device_arrays()
    om = np.ones(len(parts), np.int32)
    om[0] = 2
    true = RadarParams.make(Materials.from_list(OS.TRUE_MATS), om,
                            beam_width_deg=10.0)
    start = RadarParams.make(Materials.from_list(OS.START_MATS), om,
                             beam_width_deg=7.0)
    cfg = JCfg(**{**OS.CFG, **_FIT})
    traj = Trajectory.circular(radius=25.0, n=n_frames, period=8.0)
    poses = jnp.asarray(np.stack([traj.pose_at(t) + np.array(
        [0, 0, 2.0, 0, 0, 0, 0], np.float32) for t in traj.stamps]))
    key = jax.random.PRNGKey(3)
    keys = [jax.random.fold_in(key, i) for i in range(n_frames)]
    targets = [float_u8_image(simulate_frame_jit(sa, true, cfg, poses[i],
                                                 keys[i]), cfg)
               for i in range(n_frames)]
    loss = jnp.mean(jnp.stack([
        -psnr(float_u8_image(simulate_frame(sa, start, cfg, poses[i],
                                            keys[i]), cfg), targets[i])
        for i in range(n_frames)]))
    draws = []
    for k in keys:                       # simulate_frame's cone draws
        k_angle, k_radius = jax.random.split(jax.random.split(k)[0])
        draws.append((np.array(jax.random.uniform(
            k_angle, (cfg.n_samples,), jnp.float32, -jnp.pi, jnp.pi)),
            np.array(jax.random.normal(k_radius, (cfg.n_samples,),
                                       jnp.float32))))
    return float(loss), tuple(np.stack(x) for x in zip(*draws))


def test_opti_scale_first_loss_matches_reference(tmp_path, capsys):
    want, draws = _jax_fit_loss(12, 2, 40.0)
    out = OS.main(["--device", "cpu", "--buildings", "12", "--frames", "2",
                   "--steps", "4", "--checkpoint",
                   str(tmp_path / "ck.npz")],
                  cfg_overrides=_FIT, cone_draws=draws, extent=40.0)
    grad = out[2]
    assert grad["bench"] == "opti_gradient"
    assert grad["resumed_from_step"] == 2 and len(grad["history"]) == 4
    np.testing.assert_allclose(grad["history"][0], want, rtol=1e-5)
    # the gradient Adam takes first, and the beam width's difference
    assert len(grad["start_grad"]) == 9
    assert np.isfinite(grad["start_grad"]).all()
    assert grad["start_grad_norm"] > 0
    assert np.isfinite(grad["beam_width_central_difference"])
    assert out[3]["bench"] == "opti_black_box" and out[3]["evaluations"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4


def test_opti_scale_fixed_beam_width_tunes_the_materials_only(tmp_path,
                                                             capsys):
    out = OS.main(["--device", "cpu", "--buildings", "12", "--frames", "2",
                   "--steps", "2", "--fixed-beam-width", "--checkpoint",
                   str(tmp_path / "ck.npz")],
                  cfg_overrides=_FIT, extent=40.0)
    grad = out[2]
    assert grad["beam_width_tuned"] is False
    assert len(grad["start_grad"]) == 8
    assert "beam_width_central_difference" not in grad
    assert len(grad["history"]) == 2 and out[3]["evaluations"] > 0
    capsys.readouterr()


def test_opti_scale_resumed_fit_equals_unbroken(tmp_path):
    from radarays_ros_tpu_torch.opti.optimize import default_objective

    s = OS.fit_setup(12, 2, "cpu", cfg_overrides=_FIT, extent=40.0)
    objective = default_objective(s["scene"], s["cfg"], s["poses"],
                                  s["targets"], cone_draws=s["cone_draws"])
    resumed, step = OS.gradient_fit(objective, s["start"], s["pv"], 4,
                                    str(tmp_path / "ck.npz"), "cpu")
    unbroken, _ = OS.gradient_fit(objective, s["start"], s["pv"], 4, None,
                                  "cpu")
    assert step == 2 and (tmp_path / "ck.npz").exists()
    assert resumed == unbroken


# ----------------------------------------------------------- the proxies

@pytest.mark.parametrize("variant", ["median", "sah"])
def test_order_proxy_equals_reference(variant, capsys):
    ref = _load("order_ab")
    got = [r for r in OA.main(["--proxy", "--device", "cpu", "--buildings",
                               "300", "--rays", "2000"])
           if r["variant"] == variant][0]
    sa, _ = ref.build_arrays(300, variant)
    o, d = ref.fan(2000)
    lo, hi = np.asarray(sa.chunk_aabb_lo), np.asarray(sa.chunk_aabb_hi)
    want = ref.overlap_stats(lo, hi, o, d, 203.8)
    assert {k: got[k] for k in want} == want
    assert got["n_chunks"] == lo.shape[0]
    assert got["chunk_sa_sum"] == round(ref.chunk_sa_sum(lo, hi), 1)
    capsys.readouterr()


def test_chunksize_proxy_equals_reference(capsys):
    from radarays_ros_tpu_torch.bench import chunksize_ab as CA

    ref = _load("chunksize_ab")
    got = CA.main(["--proxy", "--device", "cpu", "--buildings", "300",
                   "--rays", "2000", "--sizes", "128,256,384"])
    o, d = ref.fan(2000)
    for rec in got:
        sa, _ = ref.build_arrays(300, rec["chunk_size"])
        lo, hi = np.asarray(sa.chunk_aabb_lo), np.asarray(sa.chunk_aabb_hi)
        want = ref.overlap_stats(lo, hi, o, d, 203.8)
        assert {k: rec[k] for k in want} == want
        assert rec["total_lanes_m"] == round(
            want["total_overlaps"] * rec["chunk_size"] / 1e6, 2)
    capsys.readouterr()
