"""The port's CUDA kernels against their plain torch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
(sm_90a) with nvcc; without torch.cuda they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

Every kernel must agree with its plain version bit for bit: both round
every product and sum separately, in the same order (-fmad=false build).
K5's backward kernel is held bit for bit to the reference's _bin_bwd and
to its per-signal plain version.
"""

import numpy as np
import pytest
import torch

from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
from radarays_ros_tpu_torch.geom.scene import Scene
from radarays_ros_tpu_torch.image.cuda_draw import (_bin_bwd,
                                                    _bin_bwd_signals,
                                                    _bin_plain, bin_bwd,
                                                    bin_signals)
from radarays_ros_tpu_torch.image.denoise import build_denoiser
from radarays_ros_tpu_torch.trace import cuda_trace as CT
from radarays_ros_tpu_torch.trace.api import trace

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    parts, names = make_urban_scene(n_buildings=1600, extent=100.0, seed=5)
    st = Scene.compose(parts, names, chunk_size=64).to_device(dev)
    assert st.n_chunks >= 8 * CT._SG           # hierarchical prep
    return st


def _fan(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    az = np.repeat(np.linspace(0, 2 * np.pi, 64, endpoint=False), n // 64)
    el = rng.normal(0.05, 0.2, az.shape[0])
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), d.shape).copy()
    bud = rng.choice([15.0, 60.0, 1000.0], d.shape[0]).astype(np.float32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(bud).to(dev))


def _kernels_equal_plain(scene, o, d, bud, rb, group):
    """The culling prep (K3 and K2, or K4 under 256 supergroups, as the
    trace's _run_prep picks) and K1 against their plain versions bit for
    bit on one ray set; returns the plain sweep's visits per 32-lane group
    and best_t."""
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(scene, o, d, bud,
                                                    ray_block=rb, group=group)
    n0 = CT.sweep.launches
    e_k, t_k = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                            kernels=True)
    e_p, t_p = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                            kernels=False)
    assert torch.equal(e_k, e_p) and torch.equal(t_k, t_p)
    nvisit, order, entry = CT._rank(e_k[:, :C2])
    args = (nvisit, order, entry, o, d, t_k, scene.coef, scene.fetch)
    kw = dict(tc=scene.chunk_size, group=group, t_min=0.0)
    got = CT.sweep(*args, **kw)
    bt_p, bi_p, rows_p, visits = CT._sweep_plain(*args, **kw,
                                                 with_visits=True)
    torch.cuda.synchronize()
    assert CT.sweep.launches == n0 + 1
    for x, y in zip(got, (bt_p, bi_p, rows_p)):
        assert torch.equal(x, y)
    return visits, bt_p


@pytest.mark.parametrize("rb,group,lanes", [
    (2048, 1, "fan"), (768, 1, "fan"), (128, 1, "fan"),
    (2048, 1, "dead_sky"), (768, 1, "dead_sky"), (128, 1, "dead_sky"),
    (2048, 2, "dead_sky"), (2048, 4, "fan"), (2048, 4, "dead_sky")])
def test_prep_and_sweep_kernels_equal_plain(scene, dev, rb, group, lanes):
    """K3, K2 (or K4) and K1 bit for bit for the split CTAs of every block
    width; "dead_sky" lanes include budget-0 (dead) lanes, whole dead
    groups and steep sky rays, and groups 2 and 4 take supergroups of 2
    and 4 chunks (the auto group of scenes above 12,288 and 24,576
    chunks)."""
    o, d, bud = _fan(8192 + 77, dev, seed=0 if lanes == "fan" else 4)
    if lanes == "dead_sky":
        d[::7, 2] = 0.9
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        bud[::3] = 0.0
        bud[:96] = 0.0
    if group == 1:
        o_p, _, inv_d, bud_p, lo, hi, _ = CT._prep_inputs(
            scene, o, d, bud, ray_block=rb, group=1)
        rbt = next(r for r in (1024, 512, 256, 128) if rb % r == 0)
        slo, shi = CT._coarse_boxes(lo, hi)
        args = (slo, shi, o_p, inv_d, bud_p, 1000.0, rbt)
        w_k, w_p = CT.coarse_words(*args), CT._coarse_words_plain(*args)
        assert torch.equal(w_k, w_p) and (w_k != 0).any()
    visits, bt = _kernels_equal_plain(scene, o, d, bud, rb, group)
    if lanes == "fan":
        assert torch.isfinite(bt).float().mean() > 0.3
    else:
        assert (visits.view(-1)[:3] == 0).all()
        assert torch.isfinite(bt).float().mean() > 0.2


def test_kernels_equal_plain_on_second_bounce(scene, dev):
    """K2 and K1 bit for bit on the second bounce's rays of a small frame
    (the pipeline's own budgets, dead waves at 0), in its ray-major
    order."""
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    n_obj = int(scene.obj_ids.max()) + 1
    params = RadarParams.make(Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.0, ambient=0.5, diffuse=0.4, specular=60.0)],
        device=dev), np.ones(n_obj, np.int32), 8.0)
    cfg = RadarModelConfig(n_angles=128, n_cells=1024, resolution=0.1,
                           n_samples=16, n_reflections=2,
                           trace_ray_block=2048)
    poses = torch.from_numpy(np.stack([make_pose([0.5, 0.5, 2.0]),
                                       make_pose([3.0, -1.0, 2.0])]))
    waves, sensor_pos = P.start_waves(
        params, cfg, poses, generator=torch.Generator(dev).manual_seed(0),
        device=dev)
    with torch.no_grad():
        waves, _ = P._bounce(cfg, params, scene, waves, sensor_pos, 0)
    assert 0.0 < float(waves.valid.float().mean()) < 1.0

    def rm(x):
        return x.movedim(0, 2).reshape(-1, *x.shape[3:]).contiguous()

    _kernels_equal_plain(scene, rm(waves.orig), rm(waves.dir),
                         rm(P.trace_budget(cfg, waves)), 2048, 1)


def test_kernel_engine_matches_brute(scene, dev):
    o, d, bud = _fan(2048, dev, seed=1)
    got = trace(scene, o, d, engine="kernel", t_budget=bud)
    ref = trace(scene, o, d, engine="brute", t_budget=bud)
    hit = ref.hit
    assert torch.equal(hit, got.hit)
    assert torch.equal(ref.obj_id, got.obj_id)
    torch.testing.assert_close(got.t[hit], ref.t[hit], rtol=1e-4, atol=1e-4)


def _bin_case(combine, case, dev):
    """(cell, s, bin kwargs) on the card; every signal has a nonzero
    strength, those with a cell out of range too, so a kernel that let an
    invalid signal into the row would differ. "uniform": 400 rows x 200
    signals over 3,424 cells, 40 duplicates a row, some out of range.
    "long": 40 rows x 2,500 signals (more than the kernel stages in shared
    memory at a time) over 3,424 cells, half of them on 8 cells.
    "clustered": as on the main path, 4 beams of 50 samples a row land
    within a few cells each, plus 3 signals (N = 203, not a multiple of
    32), over 13,000 cells (the row takes more than 48 KB of shared
    memory); some rows are all invalid, some all zero, some beams at the
    row's edges."""
    rng = np.random.default_rng(2)
    if case == "uniform":
        A, N, n_cells = 400, 200, 3424
        cell = rng.integers(-5, n_cells + 5, (A, N)).astype(np.int32)
        cell[:, :40] = rng.integers(0, 8, (A, 40))          # duplicates
    elif case == "long":
        A, N, n_cells = 40, 2500, 3424
        cell = rng.integers(-5, n_cells + 5, (A, N)).astype(np.int32)
        cell[:, ::2] = rng.integers(100, 108, (A, N - N // 2))
    else:
        A, N, n_cells = 300, 203, 13000
        base = rng.integers(0, n_cells, (A, 4))
        base[:20] = rng.choice([0, 3, n_cells - 2, n_cells - 1], (20, 4))
        spread = np.rint(rng.normal(0.0, 1.5, (A, 4, 50))).astype(np.int64)
        cell = np.concatenate([(base[:, :, None] + spread).reshape(A, 200),
                               rng.integers(-3, n_cells + 3, (A, 3))], 1)
        cell = np.where(rng.uniform(size=(A, N)) < 0.1, n_cells, cell)
        cell[40:50] = n_cells                              # all invalid
        cell = cell.astype(np.int32)
    s = rng.exponential(1.0, (A, N)).astype(np.float32)
    if case == "clustered":
        s[50:60] = 0.0                                      # all zero
    if combine == "max":
        s = s - np.float32(0.5)
    w, mode = build_denoiser(1, 35, 0.35) if combine == "taps" else (None, 0)
    kw = dict(n_cells=n_cells, combine="max" if combine == "max" else "sum",
              weights=None if w is None else tuple(map(float, w)),
              w_mode=mode)
    return torch.from_numpy(cell).to(dev), torch.from_numpy(s).to(dev), kw


@pytest.mark.parametrize("case", ["uniform", "long", "clustered"])
@pytest.mark.parametrize("combine", ["taps", "sum", "max"])
def test_bin_kernel_equals_plain(dev, combine, case):
    cell, s, kw = _bin_case(combine, case, dev)
    n0 = bin_signals.launches
    got = bin_signals(cell, s, **kw)
    want = _bin_plain(cell, s, **kw)
    torch.cuda.synchronize()
    assert bin_signals.launches == n0 + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got != 0).any()


@pytest.mark.parametrize("case", ["uniform", "long", "clustered"])
@pytest.mark.parametrize("combine", ["taps", "sum", "max"])
def test_bin_bwd_kernel_equals_plain(dev, combine, case):
    """K5's backward kernel bit for bit against the reference's _bin_bwd
    and the per-signal plain version, on the forward's own output."""
    cell, s, kw = _bin_case(combine, case, dev)
    out = bin_signals(cell, s, **kw)
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=out.shape).astype(np.float32)).to(dev)
    n0 = bin_bwd.launches
    got = bin_bwd(cell, s, out, g, **kw)
    torch.cuda.synchronize()
    assert bin_bwd.launches == n0 + 1
    for plain in (_bin_bwd, _bin_bwd_signals):
        want = plain(cell, s, out, g, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.abs().max() > 0


@pytest.mark.parametrize("n_super", [32, 128, 320, 3136])
@pytest.mark.parametrize("rbt", [1024, 512, 256, 128])
def test_coarse_words_kernel_equals_plain(scene, dev, rbt, n_super):
    """K3 bit for bit on synthetic supergroup boxes for every tile width,
    with dead lanes (budget 0) and whole dead tiles; 3,136 supergroups
    (~25M triangles at chunk 256) take three of the kernel's shared-memory
    slices, the last one partial."""
    o, d, bud = _fan(8192 + 77, dev, seed=6)
    bud[::5] = 0.0
    bud[:rbt] = 0.0
    o, _, inv_d, bud, _, _, _ = CT._prep_inputs(scene, o, d, bud,
                                                ray_block=2048, group=1)
    rng = np.random.default_rng(n_super)
    c = rng.uniform([-60, -60, 0], [60, 60, 10], (n_super, 3))
    h = rng.uniform(0.5, 8.0, (n_super, 3))
    slo = torch.from_numpy((c - h).astype(np.float32)).to(dev)
    shi = torch.from_numpy((c + h).astype(np.float32)).to(dev)
    args = (slo, shi, o, inv_d, bud, 1000.0, rbt)
    n0 = CT.coarse_words.launches
    w_k = CT.coarse_words(*args)
    w_p = CT._coarse_words_plain(*args)
    torch.cuda.synchronize()
    assert CT.coarse_words.launches == n0 + 1
    assert torch.equal(w_k, w_p)
    assert (w_k != 0).any() and (w_k[0] == 0).all()


@pytest.fixture(scope="module")
def small_scene(dev):
    parts, names = make_urban_scene(n_buildings=20, extent=40.0, seed=1)
    st = Scene.compose(parts, names, chunk_size=64).to_device(dev)
    assert st.n_chunks < 8 * CT._SG                # flat prep
    return st


def _flat_case(scene, dev, rb, n_boxes, seed=3):
    """K4's inputs: a fan of 2 * rb + 64 rays (three blocks, the last mostly
    padding) with budget-0 lanes and a wholly dead first block, and n_boxes
    boxes: a wall across the fan's +x side, random boxes around it, and as
    the last n_boxes // 8 _prep_inputs' far padding boxes. Returns (lo, hi,
    o, inv_d, bud)."""
    o, d, bud = _fan(2 * rb + 77, dev, seed=seed)
    bud[::5] = 0.0
    bud[:rb] = 0.0
    o, _, inv_d, bud, _, _, _ = CT._prep_inputs(scene, o, d, bud,
                                                ray_block=rb, group=1)
    rng = np.random.default_rng(n_boxes)
    c = rng.uniform([-60, -60, 0], [60, 60, 10], (n_boxes, 3))
    h = rng.uniform(0.5, 8.0, (n_boxes, 3))
    lo, hi = c - h, c + h
    lo[0], hi[0] = (10.0, -30.0, 0.0), (12.0, 30.0, 10.0)
    far = n_boxes - n_boxes // 8
    lo[far:], hi[far:] = 1e9, 1e9 + 1.0
    return (torch.from_numpy(lo.astype(np.float32)).to(dev),
            torch.from_numpy(hi.astype(np.float32)).to(dev), o, inv_d, bud)


@pytest.mark.parametrize("n_boxes", [1, 8, 40, 255, 1024])
@pytest.mark.parametrize("rb", [128, 768, 2048, 16384])
def test_flat_prep_kernel_equals_plain(small_scene, dev, rb, n_boxes):
    """K4 against its plain version bit for bit in clusters of 1, 3 and 8
    CTAs (ray blocks 128, 768, 2048) and at 16,384, more than 8 tiles even
    of 1,024 lanes (8 CTAs of 2,048 lanes, 8 passes each), for 1 to 1,024
    boxes (the entry point's limit; 40 on the 10k frames, at most 255 from
    _prep_inputs), with dead lanes, a dead block and far boxes."""
    lo, hi, o, inv_d, bud = _flat_case(small_scene, dev, rb, n_boxes)
    assert rb // CT._flat_tile(rb) == {128: 1, 768: 3, 2048: 8,
                                       16384: 8}[rb]
    n0 = CT.prep_flat.launches
    e_k, t_k = CT.prep_flat(lo, hi, o, inv_d, bud, 1000.0, rb)
    e_p, t_p = CT._prep_plain(lo, hi, o, inv_d, bud, 1000.0, rb,
                              CT._flat_tile(rb))
    torch.cuda.synchronize()
    assert CT.prep_flat.launches == n0 + 1
    assert torch.equal(e_k, e_p) and torch.equal(t_k, t_p)
    assert torch.isinf(e_k[0]).all() and torch.isinf(t_k).any()
    assert torch.isfinite(e_k).any() and torch.isfinite(t_k).any()


@pytest.mark.parametrize("rb", [768, 16384])
def test_flat_prep_kernel_writes_every_element(small_scene, dev, rb):
    """rr_prep_flat called directly into entry and t_last filled with NaN
    gives every element bit-equal to the plain version's: the kernel needs
    no fill. The entry point refuses clusters of more than 8 CTAs and more
    than 1,024 boxes, and the wrapper raises for the latter."""
    from radarays_ros_tpu_torch import cuda_build

    lo, hi, o, inv_d, bud = _flat_case(small_scene, dev, rb, 40, seed=5)
    Rp, Cp, rbt = o.shape[0], lo.shape[0], CT._flat_tile(rb)
    entry = torch.full((Rp // rb, Cp), float("nan"), device=dev)
    t_last = torch.full((Rp,), float("nan"), device=dev)
    lib = cuda_build.build().lib

    def call(tiles, cp=Cp):
        return lib.rr_prep_flat(
            lo.data_ptr(), hi.data_ptr(), cp, o.data_ptr(), inv_d.data_ptr(),
            bud.data_ptr(), Rp // (rb // tiles), rb // tiles, tiles, 1000.0,
            entry.data_ptr(), t_last.data_ptr(), cuda_build.stream_ptr(o))

    assert call(rb // rbt) == 0
    torch.cuda.synchronize()
    e_p, t_p = CT._prep_plain(lo, hi, o, inv_d, bud, 1000.0, rb, rbt)
    assert torch.equal(entry, e_p) and torch.equal(t_last, t_p)
    assert call(16) != 0 and call(rb // rbt, cp=1025) != 0
    big = torch.zeros(1025, 3, device=dev)
    with pytest.raises(ValueError, match="at most 1024"):
        CT.prep_flat(big, big, o, inv_d, bud, 1000.0, rb)


def test_small_scene_kernel_path_runs_flat_prep(small_scene, dev):
    o, d, bud = _fan(2048, dev, seed=2)
    n0 = CT.prep_flat.launches
    got = trace(small_scene, o, d, engine="kernel", t_budget=bud)
    assert CT.prep_flat.launches > n0
    ref = trace(small_scene, o, d, engine="sweep", t_budget=bud)
    brute = trace(small_scene, o, d, engine="brute", t_budget=bud)
    assert got.hit.any()
    for want in (ref, brute):
        assert torch.equal(want.hit, got.hit)
        assert torch.equal(want.obj_id, got.obj_id)
        torch.testing.assert_close(got.t[got.hit], want.t[got.hit],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("combine", ["sum", "taps", "max"])
def test_bin_function_backward_on_card(dev, combine):
    """Gradients through the kernels' Function equal the reference's
    _bin_bwd bit for bit on the card and the CPU Function's; the plain
    version's autograd gradient agrees exactly for sum and max and within
    1e-6 of the largest on the tap path (autograd sums the tap adjoints in
    another order)."""
    rng = np.random.default_rng(5)
    A, N, n_cells = 400, 200, 3424
    cell = rng.integers(-5, n_cells + 5, (A, N)).astype(np.int32)
    s = rng.exponential(1.0, (A, N)).astype(np.float32)
    g = rng.normal(size=(A, n_cells)).astype(np.float32)
    w, mode = build_denoiser(1, 35, 0.35) if combine == "taps" else (None, 0)
    kw = dict(n_cells=n_cells, combine="max" if combine == "max" else "sum",
              weights=w, w_mode=mode)

    def grad(fn, device):
        st = torch.from_numpy(s).to(device).requires_grad_(True)
        out = fn(torch.from_numpy(cell).to(device), st, **kw)
        out.backward(torch.from_numpy(g).to(device))
        return st.grad, out.detach()

    n0, b0 = bin_signals.launches, bin_bwd.launches
    got, out = grad(bin_signals, dev)
    torch.cuda.synchronize()
    assert bin_signals.launches == n0 + 1 and bin_bwd.launches == b0 + 1
    wt = None if w is None else tuple(map(float, w))
    want = _bin_bwd(torch.from_numpy(cell).to(dev), torch.from_numpy(s).to(
        dev), out, torch.from_numpy(g).to(dev), **dict(kw, weights=wt))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    cpu, _ = grad(bin_signals, "cpu")
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    plain, _ = grad(_bin_plain, dev)
    atol = 1e-6 * float(plain.abs().max()) if combine == "taps" else 0.0
    torch.testing.assert_close(got, plain, rtol=0, atol=atol)
    assert got.abs().max() > 0


def test_frame_gradient_through_kernels_equals_plain(small_scene, dev):
    """A non-opaque frame's loss through the kernels is bit-equal to the
    plain versions' and its gradient w.r.t. the material table and the
    beam width agrees within 1e-5 of the largest entry (gathers
    accumulate with atomics on the card)."""
    from radarays_ros_tpu_torch.opti.metrics import psnr
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.sim.pipeline import (float_u8_image,
                                                     simulate_frame)
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    mats = Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.1, ambient=0.5, diffuse=0.4, specular=60.0)],
        device=dev)
    n_obj = int(small_scene.obj_ids.max()) + 1
    cfg = RadarModelConfig(n_angles=64, n_cells=512, resolution=0.1,
                           n_samples=8, n_reflections=2, ambient_noise=0,
                           signal_denoising_triangular_width=15,
                           opaque_materials=False, record_multi_path=True)
    draws = sample_cone_draws(torch.Generator(dev).manual_seed(0), 8, 2)
    pose = torch.from_numpy(make_pose([0.5, 0.5, 2.0]))
    target = torch.full((512, 64), 3.0, device=dev)

    def loss_and_grad(c):
        leaves = [t.clone().requires_grad_(True) for t in mats]
        bw = torch.tensor(0.17, device=dev, requires_grad=True)
        params = RadarParams(Materials(*leaves), torch.ones(
            n_obj, dtype=torch.int32, device=dev), bw)
        res = simulate_frame(small_scene, params, c, pose, cone_draws=draws)
        loss = -psnr(float_u8_image(res, c), target)
        loss.backward()
        return loss.detach(), torch.cat([*(t.grad for t in leaves),
                                         bw.grad[None]])

    n0 = CT.prep_flat.launches
    lk, gk = loss_and_grad(cfg.replace(trace_engine="kernel"))
    assert CT.prep_flat.launches > n0
    lp, gp = loss_and_grad(cfg.replace(trace_engine="sweep",
                                       draw_method="plain"))
    assert torch.equal(lk, lp)
    assert torch.isfinite(gk).all() and gk.abs().max() > 0
    torch.testing.assert_close(gk, gp, rtol=0,
                               atol=1e-5 * float(gp.abs().max()))


@pytest.mark.parametrize("mode", ["single", "fan"])
def test_debug_rays_through_kernels_equal_sweep(scene, dev, mode):
    """viz.rays.trace_debug_rays on the card: a one-ray shot (4 bounces:
    1, 2, 4, 8 rays) and a 360-ray fan each run the prep and K1 on one
    partly filled 2048-ray block, and give the segments of the plain sweep
    exactly."""
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.viz.rays import trace_debug_rays

    n_obj = int(scene.obj_ids.max()) + 1
    params = RadarParams.make(Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.1, ambient=0.5, diffuse=0.4, specular=60.0)],
        device=dev), np.ones(n_obj, np.int32), 8.0)
    pose = make_pose([0.5, 0.5, 2.0])
    kw = dict(yaw=0.2, n_bounces=4, mode=mode, n_fan=360)
    n0 = CT.sweep.launches
    got = trace_debug_rays(scene, params, RadarModelConfig(
        trace_engine="kernel"), pose, **kw)
    assert CT.sweep.launches == n0 + 4
    want = trace_debug_rays(scene, params, RadarModelConfig(
        trace_engine="sweep"), pose, **kw)
    assert got == want and len(got["segments"]) > 0


def _incoherent(n, dev, seed=0):
    """Random origins over the town and random directions: every 5th ray
    steep to the sky (a miss), budgets 0 (dead lanes, and one whole dead
    32-lane group), 8, 60 or 1000."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-90, -90, 0.5), (90, 90, 25), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[::5, 2] = np.abs(d[::5, 2]) + 2.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    bud = rng.choice([0.0, 8.0, 60.0, 1000.0], n).astype(np.float32)
    bud[64:96] = 0.0
    return tuple(torch.from_numpy(a).to(dev) for a in (o, d, bud))


@pytest.mark.parametrize("extra", [dict(sort_rays=True),
                                   dict(two_phase_cap=20.0),
                                   dict(sort_rays=True, two_phase_cap=20.0)])
def test_sort_and_two_phase_on_kernel_equal_sweep(scene, dev, extra):
    """sort_rays and the two-phase requeue through the kernels on a 4k-ray
    incoherent set with dead and sky lanes: equal to the plain sweep with
    the same options, K1-K3 launched once per phase; the requeue leaves
    the single-phase result unchanged, the sort up to exact-distance
    ties."""
    o, d, bud = _incoherent(4096 + 37, dev)
    kw = dict(t_budget=bud, ray_block=2048, **extra)
    n0 = {k: getattr(CT, k).launches for k in ("sweep", "prep_hier",
                                                "coarse_words")}
    got = trace(scene, o, d, engine="kernel", **kw)
    torch.cuda.synchronize()
    phases = 2 if "two_phase_cap" in extra else 1
    assert all(getattr(CT, k).launches == n0[k] + phases for k in n0)
    want = trace(scene, o, d, engine="sweep", **kw)
    for a, b in zip(got, want):
        assert b is None if a is None else torch.equal(a, b)
    hit = got.hit
    assert 0.2 < float(hit.float().mean()) < 0.9 and not hit[64:96].any()
    single = trace(scene, o, d, engine="kernel", t_budget=bud,
                   ray_block=2048)
    assert torch.equal(single.hit, hit)
    torch.testing.assert_close(got.t[hit], single.t[hit], rtol=1e-5, atol=0)
    if "sort_rays" not in extra:
        assert torch.equal(got.obj_id, single.obj_id)
    else:
        assert float((got.obj_id != single.obj_id).float().mean()) < 0.02


def test_mxu_on_card_matches_brute(scene, dev):
    """The dense engine on the card, with TF32 off as the engine asserts
    (and refuses to run with it on): the brute oracle's hits, objects,
    distances and normals on a fan; on the incoherent set (origins inside
    buildings see floors that tie with the ground) its hits and
    distances, objects apart only on exact-distance ties."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    from radarays_ros_tpu_torch.geom.scene import with_planes

    st = with_planes(scene)
    for rays in ("fan", "incoherent"):
        o, d = (_fan(4096, dev) if rays == "fan"
                else _incoherent(4096, dev, seed=1))[:2]
        got = trace(st, o, d, engine="mxu", ray_block=2048, tri_chunk=1000)
        want = trace(st, o, d, engine="brute")
        hit = want.hit
        assert torch.equal(got.hit, hit) and hit.any()
        torch.testing.assert_close(got.t[hit], want.t[hit], rtol=1e-4,
                                   atol=1e-4)
        obj = got.obj_id != want.obj_id
        if rays == "fan":
            assert not obj.any()
            torch.testing.assert_close(got.normal, want.normal, rtol=0,
                                       atol=1e-4)
        else:
            assert float(obj.float().mean()) < 0.02
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            trace(st, o, d, engine="mxu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


_LAYOUT_NAMES = ("az", "az_smp", "scene", "az_scene")


def _within_frame_contract(got, want):
    """tests/test_oracle.py:70-87 on (u8, image_float, max_val) numpy
    triples: image within atol 2e-4 x max and rtol 2e-3, max_val within
    rtol 1e-4, u8 within 1 on >= 99.5 % of pixels and never 3 apart."""
    u8, img, mv = got
    o_u8, o_img, o_mv = want
    np.testing.assert_allclose(img, o_img, atol=2e-4 * o_img.max(),
                               rtol=2e-3)
    np.testing.assert_allclose(mv, o_mv, rtol=1e-4, atol=1e-6)
    diff = np.abs(u8.astype(int) - o_u8.astype(int))
    assert (diff <= 1).mean() >= 0.995 and diff.max() <= 3


@pytest.fixture(scope="module")
def layout_frames(dev):
    """Every layout on 2 gloo ranks sharing the card, through the kernels
    and through the plain versions, the same 2 ranks on the CPU (plain
    versions), and the card's unsharded frame through the kernels: a
    KAIST-like frame of 32 azimuths x 8 samples over a 1,600-building
    scene at chunk size 32 (its 2 scene shards take the hierarchical
    prep)."""
    from radarays_ros_tpu_torch.geom.scene import scene_tensors
    from radarays_ros_tpu_torch.parallel.dryrun import (baked, layouts_rank,
                                                        params_numpy)
    from radarays_ros_tpu_torch.parallel.launch import run_ranks
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    parts, names = make_urban_scene(n_buildings=1600, extent=100.0, seed=5)
    scene = Scene.compose(parts, names, chunk_size=32)
    host = scene.host_arrays(cache=False)
    assert host.chunk_lo.shape[0] // 2 >= 8 * CT._SG     # 304 a shard
    params = RadarParams.make(Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)]),
        np.ones(scene.n_objects, np.int32), beam_width_deg=10.0)
    cfg = RadarModelConfig(
        n_angles=32, n_cells=1024, resolution=0.1, n_samples=8,
        n_reflections=3, signal_denoising_triangular_width=15,
        ambient_noise=2, opaque_materials=True, trace_engine="auto",
        trace_ray_block=256, trace_aux_baked=True)
    rng = np.random.default_rng(0)
    inputs = dict(cone_draws=(rng.uniform(-np.pi, np.pi, 8).astype(np.float32),
                              rng.standard_normal(8).astype(np.float32)),
                  random_begin=rng.integers(0, 1000, 32))
    pose = make_pose([0.5, 0.25, 2.0])
    plain = dict(trace_engine="sweep", draw_method="plain")
    frames = [(n, n, {}) for n in _LAYOUT_NAMES] + [
        (n + "_plain", n, plain) for n in _LAYOUT_NAMES]
    setup = (host, params_numpy(params), cfg, pose, inputs)
    card = run_ranks(layouts_rank, 2, backend="gloo", device="cuda",
                     args=(setup, frames))
    cpu = run_ranks(layouts_rank, 2, backend="gloo", device="cpu",
                    args=(setup, frames[:len(_LAYOUT_NAMES)]))
    p = params.to(dev)
    one = simulate_frame(baked(scene_tensors(host, dev), p, cfg), p, cfg,
                         torch.from_numpy(pose),
                         cone_draws=tuple(torch.from_numpy(x).to(dev)
                                          for x in inputs["cone_draws"]),
                         random_begin=torch.from_numpy(
                             inputs["random_begin"]).to(dev))
    return card, cpu, tuple(x.cpu().numpy() for x in one)


@pytest.mark.parametrize("layout", _LAYOUT_NAMES)
def test_layout_on_card(layout_frames, layout):
    """A layout on 2 ranks sharing the card: through the kernels bit for
    bit its run through the plain versions on the card; bit for bit the
    card's unsharded frame where no rank cuts a sum apart (all but the SUM
    over "smp", held to the frame contract); and within the frame contract
    of the same layout's plain run on the CPU, whose transcendental
    functions round apart from the card's."""
    card, cpu, one = layout_frames
    got = card[layout]
    assert got[0].shape == (1024, 32) and got[0].max() > 0
    for a, b in zip(got, card[layout + "_plain"]):
        np.testing.assert_array_equal(a, b)
    if layout == "az_smp":
        _within_frame_contract(got, one)
    else:
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a, b)
    _within_frame_contract(got, cpu[layout])
