#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (radarays_ros_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, checks each against its
plain torch version, runs the trace exactness gate, and drives the main
paths — batched KAIST-preset radar frames over a ~1M-triangle scene and
over the ~10k-triangle companion scene, and material fitting (Adam through
the differentiable frame) at the KAIST image size.

    python3 chip_smoke.py

Phases (one line of figures each; any failure raises and exits non-zero):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build: nvcc of the kernel library (seconds);
  3. each kernel vs its plain version on the card at the trace gate's
     shapes (200k-triangle scene, 131,072-ray fan, ray block 2048) and the
     bin kernel on a synthetic (400, 200) signal set with the KAIST taps;
  4. trace gate: engine "kernel" vs engine "sweep" on the fan (0 hit and 0
     object mismatches), and a 4096-ray subset vs the brute oracle;
  5. frames: KAIST preset over make_urban_scene(83000, 300, seed=7) in
     batches of 4 — throughput with CUDA events, the launch count of every
     kernel over the timed run, each kernel vs its plain version at the
     batch's first-bounce shapes, and one frame rendered through the
     kernels and through the plain versions under the frame contract of
     tests/test_oracle.py:70-87;
  6. frames: the same preset over the 10k companion scene
     make_urban_scene(800, 300, seed=7) (40 chunks: the flat prep K4, not
     K2/K3) — throughput, launch counts (K4, K1, K5 > 0; K2, K3 = 0), K4 vs
     its plain version at the first-bounce shapes, and one frame through
     the kernels and through the plain versions;
  7. the fit (benchmarks/opti_scale.py at the KAIST image size): the
     refraction tree (opaque fast path off), 2 reflections, scene
     make_urban_scene(200, 150, seed=11), 3 frames on a circular
     trajectory, targets at the true parameters, 60 Adam steps split
     around a checkpoint save and load — steps/s, start and final PSNR,
     evaluations to 40 dB, launch counts (K4, K1, K5 > 0); one loss and
     gradient through the kernels and through the plain versions (loss
     bit-equal, gradient finite, nonzero and within 1e-5 x max|g|), and
     K5's backward time at the fit's shapes.
The last three lines of stdout are the kernel table as JSON (each row's
launches from the timed run of the path that measured it: K1, K2, K3, K5 in
phase 5, K4 in phase 6), the card's name and power limit as nvidia-smi
prints them, and the result JSON. Details also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

BATCH = 4            # frames per simulate_frames call on the main path
TIMED_BATCHES = 10
GATE_RAYS = 131072
FIT_STEPS = 60       # Adam steps of phase 7, split around a checkpoint
FIT_TARGET_DB = 40.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` calls after one warm-up,
    with CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b) -> float:
    """Max |a - b| over entries finite in both; the non-finite patterns
    must agree exactly."""
    import torch

    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb) and torch.equal(a[~fa], b[~fb]),
          "non-finite entries differ")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def frame_contract(got, want) -> dict:
    """tests/test_oracle.py:70-87 on two FrameResults of one frame."""
    import numpy as np

    img = got.image_float.double().cpu().numpy()
    ref = want.image_float.double().cpu().numpy()
    check(ref.max() > 0, "reference frame is empty")
    np.testing.assert_allclose(img, ref, atol=2e-4 * ref.max(), rtol=2e-3)
    np.testing.assert_allclose(got.max_val.double().cpu().numpy(),
                               want.max_val.double().cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    diff = np.abs(got.image_u8.cpu().numpy().astype(int)
                  - want.image_u8.cpu().numpy().astype(int))
    within = float((diff <= 1).mean())
    check(within >= 0.995 and diff.max() <= 3,
          f"u8 frame contract: {within:.4f} within 1, max {diff.max()}")
    return dict(u8_within_1=within, u8_max_diff=int(diff.max()),
                float_max_abs_diff=float(np.abs(img - ref).max()),
                bitwise=bool(np.array_equal(img, ref)))


def fan(n_rays: int, device):
    """The bench.py:78-85 gate fan: 400 azimuths x n_rays // 400
    elevations from default_rng(0) normal(0, 0.06), origin (0, 0, 2)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    A = 400
    S = n_rays // A
    az = np.repeat(np.linspace(0, 2 * np.pi, A, endpoint=False), S)
    el = np.tile(rng.normal(0, 0.06, S), A)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), d.shape).copy()
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def kernels_vs_plain(st, o, d, bud, rb: int, reps: int) -> dict:
    """The culling prep (K3 and K2, or K4 below the hierarchical threshold)
    and K1 against their plain versions on one ray set; returns per-kernel
    {max_abs_err, bitwise, ms, plain_ms}."""
    import torch

    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(st, o, d, bud,
                                                    ray_block=rb, group=1)
    out = {}
    if lo.shape[0] % CT._SG == 0 and lo.shape[0] // CT._SG >= 8:
        rbt = next(r for r in (1024, 512, 256, 128) if rb % r == 0)
        slo, shi = CT._coarse_boxes(lo, hi)
        w_k = CT.coarse_words(slo, shi, o, inv_d, bud, 1000.0, rbt)
        w_p = CT._coarse_words_plain(slo, shi, o, inv_d, bud, 1000.0, rbt)
        n_bad = int((w_k != w_p).sum())
        check(n_bad == 0, f"K3 coarse words: {n_bad} words differ")
        out["coarse_words"] = dict(
            max_abs_err=0.0, bitwise=True,
            ms=cuda_ms(lambda: CT.coarse_words(slo, shi, o, inv_d, bud,
                                               1000.0, rbt), reps),
            plain_ms=cuda_ms(lambda: CT._coarse_words_plain(
                slo, shi, o, inv_d, bud, 1000.0, rbt), max(1, reps // 5)))
        name, args = "prep_hier", (w_k, lo, hi, o, inv_d, bud, 1000.0, rb,
                                   rbt)
        e_k, t_k = CT.prep_hier(*args)
        e_p, t_p = CT._prep_plain(*args[1:], words=w_k)
        kernel, plain = CT.prep_hier, lambda: CT._prep_plain(*args[1:],
                                                             words=w_k)
    else:
        rbt = next(r for r in (256, 512, 128) if rb % r == 0)
        name, args = "prep_flat", (lo, hi, o, inv_d, bud, 1000.0, rb, rbt)
        e_k, t_k = CT.prep_flat(*args)
        e_p, t_p = CT._prep_plain(*args)
        kernel, plain = CT.prep_flat, lambda: CT._prep_plain(*args)
    err = max(max_abs(e_k, e_p), max_abs(t_k, t_p))
    bitwise = bool(torch.equal(e_k, e_p) and torch.equal(t_k, t_p))
    check(bitwise, f"{name}: not bitwise (max abs error {err})")
    out[name] = dict(max_abs_err=err, bitwise=bitwise, boxes=int(lo.shape[0]),
                     ms=cuda_ms(lambda: kernel(*args), reps),
                     plain_ms=cuda_ms(plain, max(1, reps // 5)))
    out["sweep"] = sweep_vs_plain(st, e_k, C2, o, d, t_k, reps)
    return out


def sweep_vs_plain(st, e_k, C2: int, o, d, t_k, reps: int) -> dict:
    """K1 against its plain version after the prep's entries e_k."""
    import torch

    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    nvisit, order, entry = CT._rank(e_k[:, :C2])
    args = (nvisit, order, entry, o, d, t_k, st.coef, st.fetch)
    kw = dict(tc=st.chunk_size, group=1, t_min=0.0)
    bt_k, bi_k, rows_k = CT.sweep(*args, **kw)
    bt_p, bi_p, rows_p = CT._sweep_plain(*args, **kw)
    n_win = int((bi_k != bi_p).sum())
    check(n_win == 0, f"K1 sweep: {n_win} winners differ")
    err = max(max_abs(bt_k, bt_p), max_abs(rows_k, rows_p))
    check(err <= 1e-6 * 1000.0, f"K1 sweep: max abs error {err}")
    return dict(
        max_abs_err=err, bitwise=bool(torch.equal(bt_k, bt_p)
                                      and torch.equal(rows_k, rows_p)),
        winners_differ=n_win, hit_rate=float(torch.isfinite(bt_k).float()
                                             .mean()),
        ranked_chunks_max=int(nvisit.max()),
        ranked_chunks_mean=float(nvisit.float()
                                 .mean()),
        ms=cuda_ms(lambda: CT.sweep(*args, **kw), reps),
        plain_ms=cuda_ms(lambda: CT._sweep_plain(*args, **kw), 1))


def bin_vs_plain(cell, s, weights, mode, n_cells: int, reps: int) -> dict:
    import torch

    from radarays_ros_tpu_torch.image.cuda_draw import _bin_plain, bin_signals

    kw = dict(n_cells=n_cells, combine="sum", weights=weights, w_mode=mode)
    got = bin_signals(cell, s, **kw)
    want = _bin_plain(cell, s, **kw)
    err = max_abs(got, want)
    check(err <= 1e-6 * float(want.abs().max()), f"K5 bin: error {err}")
    return dict(max_abs_err=err, bitwise=bool(torch.equal(got, want)),
                ms=cuda_ms(lambda: bin_signals(cell, s, **kw), reps),
                plain_ms=cuda_ms(lambda: _bin_plain(cell, s, **kw), 2))


def kaist_setup(device, n_buildings: int = 83000):
    """bench.py:119-182: the MulRan KAIST preset over the urban scene
    (~1M triangles, or the 10k companion at 800 buildings), opaque
    wall-stone everywhere, the material map baked."""
    import numpy as np

    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene, bake_tri_aux
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)

    t0 = time.perf_counter()
    parts, names = make_urban_scene(n_buildings=n_buildings, extent=300.0,
                                    seed=7)
    scene = Scene.compose(parts, names, chunk_size=256)
    t1 = time.perf_counter()
    st = scene.to_device(device)
    t2 = time.perf_counter()
    materials = Materials.from_list(
        [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
         dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)],
        device=device)
    om = np.ones(scene.n_objects, np.int32)
    params = RadarParams.make(materials, om, beam_width_deg=10.0)
    st = bake_tri_aux(st, params.object_materials.float()[
        st.obj_ids.clamp(0, len(om) - 1).long()])
    cfg = RadarModelConfig(
        n_angles=400, n_cells=3424, resolution=0.0595238, n_samples=50,
        n_reflections=4, beam_sample_dist=2,
        beam_sample_dist_normal_p_in_cone=0.8, energy_max=0.72,
        signal_max=110.0, signal_denoising=1,
        signal_denoising_triangular_width=35,
        signal_denoising_triangular_mode=0.35, ambient_noise=2,
        ambient_noise_at_signal_0=0.1, ambient_noise_at_signal_1=0.03,
        ambient_noise_energy_max=0.1, ambient_noise_energy_min=0.05,
        record_multi_reflection=True, record_multi_path=False,
        opaque_materials=True, trace_engine="kernel", draw_method="auto",
        trace_ray_block=2048, trace_aux_baked=True)
    return scene, st, params, cfg, dict(
        scene_gen_s=t1 - t0, host_build_and_upload_s=t2 - t1,
        n_triangles=st.n_triangles, n_chunks=st.n_chunks)


def counters():
    """Every kernel wrapper of the port, by kernel name."""
    from radarays_ros_tpu_torch.image.cuda_draw import bin_signals
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    return {"sweep": CT.sweep, "prep_hier": CT.prep_hier,
            "coarse_words": CT.coarse_words, "prep_flat": CT.prep_flat,
            "bin": bin_signals}


def frames_phase(tag: str, st, params, cfg, dev, expect_zero=(),
                 min_column_share: float = 0.5):
    """Timed KAIST batches on one scene (the launch count of every kernel
    over the timed run; those in expect_zero must stay at 0, the others
    must launch; every frame has signal in at least min_column_share of
    its columns), each kernel of the path vs its plain version at the
    batch's first-bounce shapes, and one frame through the kernels and
    through the plain versions under the frame contract. Returns (frame
    figures, launches, kernels vs plain, frame vs plain)."""
    import numpy as np
    import torch

    from radarays_ros_tpu_torch.image.draw import bin_cells
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.wave.cone import sample_cone_local

    poses = torch.from_numpy(np.stack(
        [make_pose([0.5 * f, 0.25 * f, 2.0]) for f in range(BATCH)]))
    gen = torch.Generator(dev).manual_seed(0)

    def run_batch():
        return P.simulate_frames(st, params, cfg, poses, generator=gen)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_batch()                              # warm-up, not counted
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_BATCHES):
        res = run_batch()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    dev_ms = start.elapsed_time(end)
    n_frames = TIMED_BATCHES * BATCH
    check(all((n == 0) == (k in expect_zero) for k, n in launches.items()),
          f"launches {launches}: {list(expect_zero)} must be 0, the others "
          "above 0")
    nz_cols = (res.image_u8 > 0).any(dim=1).float().mean(dim=1)
    check(bool((nz_cols >= min_column_share).all()),
          f"trivial image: {nz_cols.tolist()}")
    check(bool(torch.isfinite(res.image_float).all()), "non-finite image")
    check(tuple(res.image_u8.shape) == (BATCH, cfg.n_cells, cfg.n_angles),
          f"image shape {tuple(res.image_u8.shape)}")
    frames = dict(
        batch=BATCH, timed_batches=TIMED_BATCHES,
        frames_per_s=n_frames / (dev_ms / 1e3),
        ms_per_frame=dev_ms / n_frames, wall_frames_per_s=n_frames / wall,
        warmup_batch_s=warm_s, launches=launches,
        nonzero_column_share=nz_cols.tolist(),
        mean_pixel=float(res.image_u8.float().mean()))
    log(f"[{tag} frames] {json.dumps(frames)}")
    del warm, res

    # kernels vs plain at the path's first-bounce shapes
    local = torch.stack([sample_cone_local(
        gen, params.beam_width, cfg.n_samples, cfg.beam_sample_dist,
        cfg.beam_sample_dist_normal_p_in_cone) for _ in range(BATCH)])
    waves, sensor_pos = P.start_waves(params, cfg, poses, local_dirs=local,
                                      device=dev)
    budget = P.trace_budget(cfg, waves)

    def rm(x):
        return x.movedim(0, 2).reshape(-1, *x.shape[3:]).contiguous()

    mk = kernels_vs_plain(st, rm(waves.orig), rm(waves.dir), rm(budget),
                          rb=cfg.trace_ray_block, reps=10)
    times, strengths, valid = P.collect_signals(st, params, cfg, waves,
                                                sensor_pos)
    N, A = times.shape[:2]
    c = bin_cells(times.reshape(N * A, -1), cfg.resolution)
    ok = valid.reshape(N * A, -1) & (c >= 0) & (c < cfg.n_cells)
    w, mode = cfg.denoiser()
    mk["bin"] = bin_vs_plain(
        torch.where(ok, c, cfg.n_cells).to(torch.int32).contiguous(),
        torch.where(ok, strengths.reshape(N * A, -1), 0.0).contiguous(),
        w, mode, cfg.n_cells, reps=20)
    log(f"[{tag} kernels vs plain, first-bounce shapes: "
        f"{int(np.prod(waves.batch_shape))} rays, {N * A} rows] "
        + json.dumps({k: {kk: v[kk] for kk in ("bitwise", "max_abs_err",
                                              "ms", "plain_ms")}
                      for k, v in mk.items()}))

    # one frame through the kernels and through the plain versions
    pose = poses[0]
    rbeg = torch.randint(0, 1000, (cfg.n_angles,), generator=gen, device=dev)
    kw = dict(local_dirs=local[0], random_begin=rbeg)
    t0 = time.perf_counter()
    fk = P.simulate_frame(st, params, cfg, pose, **kw)
    torch.cuda.synchronize()
    kernel_frame_s = time.perf_counter() - t0
    plain_cfg = cfg.replace(trace_engine="sweep", draw_method="plain")
    t0 = time.perf_counter()
    fp = P.simulate_frame(st, params, plain_cfg, pose, **kw)
    torch.cuda.synchronize()
    plain_frame_s = time.perf_counter() - t0
    fvp = dict(kernel_frame_s=kernel_frame_s, plain_frame_s=plain_frame_s,
               **frame_contract(fk, fp))
    log(f"[{tag} frame kernels vs plain] {json.dumps(fvp)}")
    return frames, launches, mk, fvp


def fit_setup(device):
    """benchmarks/opti_scale.py at the KAIST image size: its scene, true
    and start materials (wall on buildings, "glass" on the ground), the
    9-dim vector (beam width + both slots), the refraction tree with 2
    reflections, 3 frames on its circular trajectory, fixed cone draws."""
    import math

    import numpy as np
    import torch

    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene, bake_tri_aux
    from radarays_ros_tpu_torch.opti.optimize import ParamVector
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    parts, names = make_urban_scene(n_buildings=200, extent=150.0, seed=11)
    scene = Scene.compose(parts, names, chunk_size=256)
    st = scene.to_device(device)
    om = np.ones(scene.n_objects, np.int32)
    om[0] = 2                                      # the ground
    st = bake_tri_aux(st, torch.from_numpy(om).to(device).float()[
        st.obj_ids.clamp(0, len(om) - 1).long()])

    def params(mats, deg):
        return RadarParams.make(Materials.from_list(mats, device=device), om,
                                beam_width_deg=deg)

    air = dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0)
    true = params([air,
                   dict(velocity=0.0, ambient=0.85, diffuse=0.15,
                        specular=900.0),
                   dict(velocity=0.0, ambient=0.35, diffuse=0.6,
                        specular=150.0)], 10.0)
    start = params([air,
                    dict(velocity=0.0, ambient=0.3, diffuse=0.6,
                         specular=150.0),
                    dict(velocity=0.0, ambient=0.9, diffuse=0.05,
                         specular=2000.0)], 7.0)
    cfg = RadarModelConfig(
        n_angles=400, n_cells=3424, resolution=0.0595238, n_samples=50,
        n_reflections=2, beam_sample_dist=2,
        beam_sample_dist_normal_p_in_cone=0.8, energy_max=0.72,
        signal_max=110.0, signal_denoising=1,
        signal_denoising_triangular_width=35,
        signal_denoising_triangular_mode=0.35, ambient_noise=0,
        record_multi_reflection=True, record_multi_path=False,
        opaque_materials=False, trace_engine="kernel", draw_method="auto",
        trace_ray_block=2048, trace_aux_baked=True)
    # Trajectory.circular(radius=25, n=3, period=8) + 2 m of height
    ang = 2 * np.pi * np.arange(3) / 3
    poses = np.zeros((3, 7), np.float32)
    poses[:, 0], poses[:, 1], poses[:, 2] = (25 * np.cos(ang),
                                             25 * np.sin(ang), 2.0)
    poses[:, 5] = np.sin((ang + np.pi / 2) / 2)
    poses[:, 6] = np.cos((ang + np.pi / 2) / 2)
    gen = torch.Generator(device).manual_seed(3)
    draws = [sample_cone_draws(gen, cfg.n_samples, cfg.beam_sample_dist)
             for _ in range(3)]
    pv = ParamVector(material_slots=(1, 2), tune_beam_width=True,
                     tune_n_reflections=False)
    return (st, true, start, cfg, torch.from_numpy(poses),
            tuple(torch.stack(d) for d in zip(*draws)), pv)


def fit_phase(dev) -> dict:
    """Phase 7: targets at the true parameters, 60 Adam steps around a
    checkpoint save and load, launch counts, PSNR, and one loss and
    gradient through the kernels and through the plain versions."""
    import math
    import tempfile

    import torch

    from radarays_ros_tpu_torch.image.cuda_draw import _bin_bwd
    from radarays_ros_tpu_torch.image.draw import bin_cells
    from radarays_ros_tpu_torch.opti.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from radarays_ros_tpu_torch.opti.optimize import (default_objective,
                                                      optimize_gradient,
                                                      step_loss_fn)
    from radarays_ros_tpu_torch.sim import pipeline as P

    t0 = time.perf_counter()
    st, true, start, cfg, poses, draws, pv = fit_setup(dev)
    with torch.no_grad():
        targets = P.float_u8_image(P.simulate_frames(
            st, true, cfg, poses, cone_draws=draws), cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(bool(torch.isfinite(targets).all()) and float(targets.max()) > 0,
          "fit targets are empty or not finite")
    objective = default_objective(st, cfg, poses, targets, cone_draws=draws)
    info = dict(n_triangles=st.n_triangles, n_chunks=st.n_chunks,
                setup_s=setup_s, true_psnr_db=-float(objective(true)))

    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    half = FIT_STEPS // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = optimize_gradient(objective, start, pv, steps=half, lr=0.08)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit_ck.npz")
        save_checkpoint(path, res1.params, vec=res1.vec,
                        history=res1.history, step=half)
        resumed, extras = load_checkpoint(path, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res2 = optimize_gradient(objective, resumed, pv,
                             steps=FIT_STEPS - half, lr=0.04)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # the first half carries the process's first backward passes (a
    # one-time cost of several seconds); the second half is steady state
    second_s = time.perf_counter() - t1
    launches = {k: fn.launches for k, fn in wrappers.items()}
    hist = list(res1.history) + list(res2.history)
    check(all(launches[k] > 0 for k in ("prep_flat", "sweep", "bin"))
          and launches["prep_hier"] == 0 and launches["coarse_words"] == 0,
          f"fit launches {launches}")
    check(extras["step"] == half, "checkpoint step")
    check(all(map(math.isfinite, hist)), "non-finite fit loss")
    to_target = next((i + 1 for i, v in enumerate(hist)
                      if v <= -FIT_TARGET_DB), None)
    info.update(steps=FIT_STEPS, fit_s=fit_s, steps_per_s=FIT_STEPS / fit_s,
                first_half_s=fit_s - second_s, second_half_s=second_s,
                steady_steps_per_s=(FIT_STEPS - half) / second_s,
                start_psnr_db=-hist[0], final_psnr_db=-min(hist),
                evals_to_target=to_target, target_psnr_db=FIT_TARGET_DB,
                resumed_from_step=int(extras["step"]), launches=launches,
                final_vec=[float(x) for x in res2.vec],
                history_psnr_db=[-v for v in hist])
    check(info["final_psnr_db"] > info["start_psnr_db"],
          "the fit's PSNR did not rise")

    # one loss and gradient through the kernels and the plain versions
    def loss_grad(c):
        obj = default_objective(st, c, poses, targets, cone_draws=draws)
        step_loss, _, to_z = step_loss_fn(obj, start, pv)
        z = to_z(pv.to_vec(start)).requires_grad_(True)
        loss = step_loss(z)
        loss.backward()
        return loss.detach(), z.grad

    lk, gk = loss_grad(cfg)
    lp, gp = loss_grad(cfg.replace(trace_engine="sweep", draw_method="plain"))
    g_err = float((gk - gp).abs().max())
    info.update(loss_kernel=float(lk), loss_plain=float(lp),
                loss_bitwise=bool(torch.equal(lk, lp)),
                grad_kernel=gk.tolist(), grad_plain=gp.tolist(),
                grad_max_abs_err=g_err)
    check(bool(torch.isfinite(gk).all()), f"non-finite gradient {gk}")
    check(bool(gk.abs().max() > 0), "all-zero gradient")
    check(info["loss_bitwise"], f"loss kernel {lk} vs plain {lp}")
    check(g_err <= 1e-5 * float(gp.abs().max()),
          f"gradient kernel vs plain: max abs error {g_err}")

    # K5 forward and backward at the fit's shapes (the start's signals)
    with torch.no_grad():
        waves, sensor_pos = P.start_waves(start, cfg, poses,
                                          cone_draws=draws, device=dev)
        times, strengths, valid = P.collect_signals(st, start, cfg, waves,
                                                    sensor_pos)
    N, A = times.shape[:2]
    c = bin_cells(times.reshape(N * A, -1), cfg.resolution)
    ok = valid.reshape(N * A, -1) & (c >= 0) & (c < cfg.n_cells)
    cell = torch.where(ok, c, cfg.n_cells).to(torch.int32).contiguous()
    s = torch.where(ok, strengths.reshape(N * A, -1), 0.0).contiguous()
    w, mode = cfg.denoiser()
    k5 = bin_vs_plain(cell, s, w, mode, cfg.n_cells, reps=20)
    g = torch.randn(N * A, cfg.n_cells, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    wt = tuple(float(x) for x in w)
    k5["backward_ms"] = cuda_ms(lambda: _bin_bwd(
        cell, s, None, g, n_cells=cfg.n_cells, combine="sum", weights=wt,
        w_mode=mode), 20)
    k5["rows"], k5["signals_per_row"] = N * A, int(cell.shape[1])
    info["bin_fit_shapes"] = k5
    long = ("grad_kernel", "grad_plain", "history_psnr_db")
    log(f"[7 fit] {json.dumps({k: v for k, v in info.items() if k not in long})}")
    return info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    import radarays_ros_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from radarays_ros_tpu_torch import cuda_build
    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene
    from radarays_ros_tpu_torch.sim.config import RadarModelConfig
    from radarays_ros_tpu_torch.trace.api import trace

    dev = torch.device("cuda")
    details = {}

    # ---- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    tf32 = dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                matmul_precision=torch.get_float32_matmul_precision())
    check(not tf32["matmul_allow_tf32"] and not tf32["cudnn_allow_tf32"]
          and tf32["matmul_precision"] == "highest", f"TF32 on: {tf32}")
    details["env"] = dict(gpu=smi, torch=torch.__version__,
                          cuda=torch.version.cuda, python=sys.version.split()[0],
                          device_count=torch.cuda.device_count(), **tf32)
    log(f"[1 env] {json.dumps(details['env'])}")

    # ---- 2. build
    b = cuda_build.build()
    details["build"] = dict(seconds=b.seconds, library=b.path.name)
    log(f"[2 build] nvcc {b.seconds:.2f} s -> {b.path.name}")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(b.log)

    # ---- 3. kernels vs plain at the gate's shapes
    t0 = time.perf_counter()
    parts, names = make_urban_scene(n_buildings=16600, extent=140.0, seed=11)
    gate = Scene.compose(parts, names, chunk_size=256).to_device(dev)
    gate_build = time.perf_counter() - t0
    o, d = fan(GATE_RAYS, dev)          # 400 x 327 = 130,800 rays
    n_rays = o.shape[0]
    bud = torch.full((n_rays,), 1000.0, device=dev)
    gk = kernels_vs_plain(gate, o, d, bud, rb=2048, reps=5)
    w, mode = RadarModelConfig(signal_denoising_triangular_width=35,
                               signal_denoising_triangular_mode=0.35
                               ).denoiser()
    rng = np.random.default_rng(1)
    cell = torch.from_numpy(rng.integers(-10, 3434, (400, 200))
                            .astype(np.int32)).to(dev)
    s = torch.from_numpy(rng.exponential(1.0, (400, 200))
                         .astype(np.float32)).to(dev)
    gk["bin"] = bin_vs_plain(cell, s, w, mode, 3424, reps=20)
    details["kernels_gate"] = dict(n_triangles=gate.n_triangles,
                                   n_chunks=gate.n_chunks,
                                   host_build_s=gate_build, **gk)
    log(f"[3 kernels vs plain, gate shapes: {gate.n_triangles} tris, "
        f"{gate.n_chunks} chunks, {n_rays} rays] "
        + json.dumps({k: {kk: v[kk] for kk in ("bitwise", "max_abs_err",
                                              "ms", "plain_ms")}
                      for k, v in gk.items()}))

    # ---- 4. trace gate
    rk = trace(gate, o, d, engine="kernel")
    rs = trace(gate, o, d, engine="sweep")
    common = rk.hit & rs.hit
    hit_mm = int((rk.hit != rs.hit).sum())
    obj_mm = int((rk.obj_id[common] != rs.obj_id[common]).sum())
    max_dt = float((rk.t[common] - rs.t[common]).abs().max())
    sub = torch.arange(0, n_rays, n_rays // 4096, device=dev)[:4096]
    rb_ = trace(gate, o[sub], d[sub], engine="brute")
    hit_b = rb_.hit
    brute_ok = (torch.equal(hit_b, rk.hit[sub])
                and torch.equal(rb_.obj_id, rk.obj_id[sub])
                and torch.allclose(rk.t[sub][hit_b], rb_.t[hit_b],
                                   rtol=1e-4, atol=1e-4)
                and torch.allclose(rk.normal[sub], rb_.normal, atol=1e-4))
    details["trace_gate"] = dict(
        n_rays=n_rays, hit_rate=float(rk.hit.float().mean()),
        hit_mismatches=hit_mm, obj_mismatches_on_common_hits=obj_mm,
        max_abs_dt_on_common_hits=max_dt, brute_subset=int(sub.numel()),
        brute_contract=bool(brute_ok))
    log(f"[4 trace gate] {json.dumps(details['trace_gate'])}")
    check(hit_mm == 0 and obj_mm == 0, "trace gate mismatches")
    check(brute_ok, "brute contract on the 4096-ray subset")
    del gate, rk, rs, o, d

    # ---- 5. frames on the main path
    scene, st, params, cfg, info = kaist_setup(dev)
    log(f"[5 scene] {json.dumps(info)}")
    frames, launches, mk, fvp = frames_phase("5", st, params, cfg, dev,
                                             expect_zero=("prep_flat",))
    details.update(frames=dict(frames, gpu=smi), kernels_main_path=mk,
                   frame_vs_plain=fvp)
    del scene, st

    # ---- 6. frames on the 10k companion scene (the flat prep K4)
    scene, st, params, cfg, info = kaist_setup(dev, n_buildings=800)
    log(f"[6 scene] {json.dumps(info)}")
    frames10, launches10, mk10, fvp10 = frames_phase(
        "6", st, params, cfg, dev, expect_zero=("prep_hier", "coarse_words"),
        min_column_share=0.1)      # 800 buildings over 600 m x 600 m
    details.update(frames_10k=dict(frames10, gpu=smi), kernels_10k=mk10,
                   frame_vs_plain_10k=fvp10)
    del scene, st

    # ---- 7. the fit
    details["fit"] = fit_phase(dev)
    details["fit"]["gpu"] = smi

    source = {"sweep": "radarays_ros_tpu_torch/csrc/sweep.cu",
              "prep_hier": "radarays_ros_tpu_torch/csrc/prep.cu",
              "coarse_words": "radarays_ros_tpu_torch/csrc/prep.cu",
              "prep_flat": "radarays_ros_tpu_torch/csrc/prep.cu",
              "bin": "radarays_ros_tpu_torch/csrc/bin.cu"}
    replaces = {
        "sweep": "radarays_ros_tpu/trace/pallas_trace.py:99",
        "prep_hier": "radarays_ros_tpu/trace/pallas_trace.py:523",
        "coarse_words": "radarays_ros_tpu/trace/pallas_trace.py:584",
        "prep_flat": "radarays_ros_tpu/trace/pallas_trace.py:488",
        "bin": "radarays_ros_tpu/image/pallas_draw.py:33"}
    # each row from the path whose timed run and shapes measured it: K4
    # runs only on scenes under 256 supergroups (phase 6), the rest on the
    # 1M-triangle frames (phase 5)
    rows = {k: (launches10, mk10) if k == "prep_flat" else (launches, mk)
            for k in source}
    table = [dict(name=k, route="cuda", source=source[k],
                  replaces=replaces[k], launches=rows[k][0][k],
                  max_abs_err=rows[k][1][k]["max_abs_err"],
                  ms=rows[k][1][k]["ms"], plain_ms=rows[k][1][k]["plain_ms"])
             for k in source]
    details["kernels"] = table
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=2)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
