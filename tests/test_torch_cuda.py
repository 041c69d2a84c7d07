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

from radarays_ros_tpu_torch.bench import common as BC
from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
from radarays_ros_tpu_torch.geom.scene import Scene
from radarays_ros_tpu_torch.image.cuda_draw import (_bin_bwd,
                                                    _bin_bwd_signals,
                                                    _bin_plain, bin_bwd,
                                                    bin_signals)
from radarays_ros_tpu_torch.image.denoise import build_denoiser
from radarays_ros_tpu_torch.sim.lookup import (MAX_MATERIALS,
                                               MaterialCapRefused,
                                               _table_grad_plain, table_grad)
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


def _fan(n, dev, seed=0, n_az=64):
    rng = np.random.default_rng(seed)
    az = np.repeat(np.linspace(0, 2 * np.pi, n_az, endpoint=False),
                   n // n_az)
    el = rng.normal(0.05, 0.2, az.shape[0])
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), d.shape).copy()
    bud = rng.choice([15.0, 60.0, 1000.0], d.shape[0]).astype(np.float32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(bud).to(dev))


def _kernels_equal_plain(scene, o, d, bud, rb, group, split=None):
    """The culling prep (K3 and K2, or K4 under 256 supergroups, as the
    trace's _run_prep picks) and K1 against their plain versions bit for
    bit on one ray set, K1 (box gate included) at `split` row slices a
    lane (None: the wrapper's rule) against the plain version at its group
    width; returns the plain sweep's visits per group and best_t."""
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(scene, o, d, bud,
                                                    ray_block=rb, group=group)
    n0 = CT.sweep.launches
    e_k, t_k = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                            kernels=True)
    e_p, t_p = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                            kernels=False)
    assert torch.equal(e_k, e_p) and torch.equal(t_k, t_p)
    nvisit, order, entry = CT._rank(e_k[:, :C2])
    args = (nvisit, order, entry, o, d, t_k, scene.coef, scene.fetch, inv_d,
            bud, scene.chunk_lo, scene.chunk_hi)
    kw = dict(tc=scene.chunk_size, group=group, t_min=0.0, t_max=1000.0)
    got = CT.sweep(*args, **kw, _split=split)
    P = CT.sweep.last_split
    assert split in (None, P)
    bt_p, bi_p, rows_p, visits, tested = CT._sweep_plain(
        *args, **kw, with_visits=True, lanes=32 // P)
    torch.cuda.synchronize()
    assert CT.sweep.launches == n0 + 1
    for x, y in zip(got, (bt_p, bi_p, rows_p)):
        assert torch.equal(x, y)
    assert (tested <= visits * group).all()
    return visits, bt_p


def _lanes(kind, dev):
    """8,269 rays of a fan ("fan"), or of the fan with budget-0 (dead)
    lanes, whole dead groups and steep sky rays ("dead_sky")."""
    o, d, bud = _fan(8192 + 77, dev, seed=0 if kind == "fan" else 4)
    if kind == "dead_sky":
        d[::7, 2] = 0.9
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        bud[::3] = 0.0
        bud[:96] = 0.0
    return o, d, bud


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
    o, d, bud = _lanes(lanes, dev)
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


def _tied(scene):
    """`scene` with rows 4m + 2 and 4m + 3 of every chunk replaced by
    copies of rows 4m and 4m + 1 (the chunk boxes still hold every row):
    a hit on a copy ties with its original, one row pair earlier and so in
    another row slice; the lower row must win."""
    src = torch.arange(scene.coef.shape[0], device=scene.coef.device)
    src = src - 2 * (src % 4 >= 2)
    return scene._replace(**{k: getattr(scene, k)[src].contiguous()
                             for k in ("verts", "obj_ids", "normals",
                                       "coef", "fetch")})


@pytest.mark.parametrize("case", ["one_frame", "dead_sky_1", "dead_sky_2",
                                  "dead_sky_4", "ties"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_sweep_row_slices_equal_plain(scene, dev, split, case):
    """K1 at each number of row slices a lane, bit for bit against the
    plain version at its group width: one KAIST frame's shape (400 x 50
    rays, 10 blocks of 2,048), the dead and sky lanes at prep groups 1, 2
    and 4, and a scene of tied rows, whose winners must be the lower
    copies."""
    st, group = scene, 1
    if case == "one_frame":
        o, d, bud = _fan(400 * 50, dev, seed=2, n_az=400)
    elif case == "ties":
        st = _tied(scene)
        o, d, bud = _lanes("fan", dev)
    else:
        o, d, bud = _lanes("dead_sky", dev)
        group = int(case[-1])
    _, bt = _kernels_equal_plain(st, o, d, bud, 2048, group, split=split)
    assert torch.isfinite(bt).float().mean() > 0.2
    if case == "ties":
        tri = CT.sweep(*_sweep_args(st, o, d, bud), tc=st.chunk_size,
                       group=1, t_min=0.0, t_max=1000.0, _split=split)[1]
        hit = tri[tri >= 0]
        assert hit.numel() > 1000 and bool((hit % 4 < 2).all())


def _sweep_args(st, o, d, bud, rb=2048, group=1):
    """K1's positional arguments for rays o, d, bud after the kernels'
    prep and ranking."""
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(st, o, d, bud,
                                                    ray_block=rb, group=group)
    e, t = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=rb,
                        kernels=True)
    nvisit, order, entry = CT._rank(e[:, :C2])
    return (nvisit, order, entry, o, d, t, st.coef, st.fetch, inv_d, bud,
            st.chunk_lo, st.chunk_hi)


def test_sweep_split_rule_on_card(scene, dev):
    """The wrapper's row slices follow _sweep_split of the launch's CTAs
    and the card's resident CTAs; a launch that fills the card takes one
    thread a lane, and `split_launches` counts the others."""
    resident = CT.sweep_resident(dev.index, scene.chunk_size)
    assert resident >= torch.cuda.get_device_properties(
        0).multi_processor_count
    kw = dict(tc=scene.chunk_size, group=1, t_min=0.0, t_max=1000.0)
    for n in (400 * 50, resident * 128):
        o, d, bud = _fan(n, dev, seed=2, n_az=400 if n == 20000 else 64)
        args = _sweep_args(scene, o, d, bud)
        n_ctas = args[3].shape[0] // 128
        s0 = CT.sweep.split_launches
        CT.sweep(*args, **kw)
        want = CT._sweep_split(n_ctas, resident)
        assert CT.sweep.last_split == want
        assert CT.sweep.split_launches == s0 + (want > 1)
    assert want == 1
    with pytest.raises(ValueError, match="row slices"):
        CT.sweep(*args, **kw, _split=3)


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


@pytest.fixture(scope="module")
def loop_frame(dev):
    """One frame on the benchmark's loop: portbench's kaist02-1m scene
    (996,002 triangles, 3,896 chunks), its first pose and live1's held
    cone draws; the rays and budgets of each bounce (400 x 50 rays, 10
    blocks of 2,048), in the trace's ray-major order."""
    import json
    from pathlib import Path

    from portbench import system as S
    from portbench.generator import cone_draws
    from portbench.scene import loop_pose
    from radarays_ros_tpu_torch.sim import pipeline as P

    root = Path(__file__).resolve().parents[1] / "portbench"
    conf = json.loads((root / "configs" / "kaist02-1m.json").read_text())
    held = json.loads((root / "traffic" / "live1.json").read_text())[
        "held_cone_seed"]
    system = S.build(conf, dev)
    cfg = system.cfg
    params = S.port_params(S.material_table(conf["materials"], dev),
                           system.object_materials, conf["beam_width_deg"])
    tr = conf["trajectory"]
    pose = torch.from_numpy(loop_pose(np.radians([tr["phase_deg"]]),
                                      tr["radius"], tr["height"]))
    waves, sensor_pos = P.start_waves(
        params, cfg, pose, device=dev,
        cone_draws=cone_draws(torch.Generator(dev).manual_seed(held), 1, cfg))

    def rm(x):
        return x.movedim(0, 2).reshape(-1, *x.shape[3:]).contiguous()

    bounces = []
    for pass_id in range(cfg.n_reflections):
        bounces.append((rm(waves.orig), rm(waves.dir),
                        rm(P.trace_budget(cfg, waves))))
        with torch.no_grad():
            waves, _ = P._bounce(cfg, params, system.scene, waves,
                                 sensor_pos, pass_id)
    return system.scene, cfg.trace_ray_block, bounces


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("split", [1, 4])
def test_sweep_equals_plain_on_the_loops_frame(loop_frame, split, group):
    """K1 with its box gate bit for bit against the plain version on each
    bounce of one frame on the benchmark's loop, at one thread a lane and
    at the 4 row slices the wrapper picks there, at prep group 1 (the
    scene's own) and 4 (each sub-chunk gated by its own box)."""
    st, rb, bounces = loop_frame
    for o, d, bud in bounces:
        _, bt = _kernels_equal_plain(st, o, d, bud, rb, group, split=split)
        assert torch.isfinite(bt).any()


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
    row's edges. "fit": the fit's shapes (3 frames x 400 azimuths, 150
    signals a row over 3,424 cells: 50 cone samples of one beam on pass 1,
    100 on pass 2), "kaist": a KAIST batch of 4 (1,600 x 200); both with
    the signals of a pass clustered in a few cells and a third invalid.
    "wide": 64 rows of 600 signals spread over 40,000 cells, so that few
    signals share a cell and the taps' windows seldom overlap. combine
    "taps1" and "taps256": one tap, and the kernels' most taps."""
    rng = np.random.default_rng(2)
    if case in ("fit", "kaist"):
        A, N, n_cells = (1200, 150, 3424) if case == "fit" else (1600, 200,
                                                                 3424)
        base = rng.integers(0, n_cells, (A, N // 50, 1))
        spread = np.rint(rng.normal(0.0, 3.0, (A, N // 50, 50)))
        cell = (base + spread).reshape(A, N).astype(np.int64)
        cell = np.where(rng.uniform(size=(A, N)) < 0.33, n_cells, cell)
        cell = cell.astype(np.int32)
    elif case == "wide":
        A, N, n_cells = 64, 600, 40000
        cell = rng.integers(-5, n_cells + 5, (A, N)).astype(np.int32)
    elif case == "uniform":
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
    w, mode = {"taps": build_denoiser(1, 35, 0.35),
               "taps1": (np.float32([0.75]), 0),
               "taps256": build_denoiser(1, 256, 0.35)}.get(combine,
                                                             (None, 0))
    kw = dict(n_cells=n_cells, combine="max" if combine == "max" else "sum",
              weights=None if w is None else tuple(map(float, w)),
              w_mode=mode)
    return torch.from_numpy(cell).to(dev), torch.from_numpy(s).to(dev), kw


# K5 and its backward at the main path's shapes and at the edges of what
# the kernels take (see _bin_case)
_BIN_CASES = ["uniform", "long", "clustered", "fit", "kaist", "wide"]
_BIN_COMBINES = ["taps", "sum", "max", "taps1", "taps256"]


@pytest.mark.parametrize("case", _BIN_CASES)
@pytest.mark.parametrize("combine", _BIN_COMBINES)
def test_bin_kernel_equals_plain(dev, combine, case):
    cell, s, kw = _bin_case(combine, case, dev)
    n0 = bin_signals.launches
    got = bin_signals(cell, s, **kw)
    want = _bin_plain(cell, s, **kw)
    torch.cuda.synchronize()
    assert bin_signals.launches == n0 + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got != 0).any()


@pytest.mark.parametrize("case", _BIN_CASES)
@pytest.mark.parametrize("combine", _BIN_COMBINES)
def test_bin_bwd_kernel_equals_plain(dev, combine, case):
    """K5's backward kernel bit for bit against the reference's _bin_bwd
    and the per-signal plain version, on the forward's own output, at the
    fit's and the KAIST shapes among the others."""
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


@pytest.mark.parametrize("n,M", [(60000, 3), (120000, 3), (1, 3), (1025, 7),
                                 (3100, MAX_MATERIALS),
                                 (120000, MAX_MATERIALS)])
def test_table_grad_kernel_equals_plain(dev, n, M):
    """The material lookup's backward kernel bit for bit against its plain
    version and against itself over two launches, at the fit's row counts
    (60,000 and 120,000: pass 1 and 2) and at the material cap, with runs
    of one material, signed zeros and magnitudes over six decades; within
    1e-6 x sum|g| per entry of index_add_; a larger table is refused
    before launch."""
    rng = np.random.default_rng(n + M)
    idx = rng.integers(0, M, n)
    idx[: n // 3] = rng.integers(0, M)
    g = (rng.normal(size=(n, 4)) * 10.0 ** rng.integers(-3, 4, (n, 4)))
    g = g.astype(np.float32)
    g[rng.uniform(size=(n, 4)) < 0.1] = -0.0
    idx, g = torch.from_numpy(idx).to(dev), torch.from_numpy(g).to(dev)
    n0 = table_grad.launches
    got = table_grad(idx, g, M)
    again = table_grad(idx, g, M)
    torch.cuda.synchronize()
    assert table_grad.launches == n0 + 2
    want = _table_grad_plain(idx, g, M)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    lib = torch.zeros((M, 4), device=dev).index_add_(0, idx, g)
    sum_abs = torch.zeros((M, 4), dtype=torch.float64, device=dev) \
        .index_add_(0, idx, g.abs().double())
    assert ((got - lib).abs() <= 1e-6 * sum_abs).all()
    with pytest.raises(MaterialCapRefused):
        table_grad(idx, g, M + MAX_MATERIALS)
    assert table_grad.launches == n0 + 2


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
    beam width agrees within 1e-5 of the largest entry (the plain
    binning's autograd sums the tap adjoints in another order than K5's
    backward)."""
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


def test_steady_fit_step_launches_no_index_backward(small_scene, dev):
    """A steady Adam step of a refraction-tree fit with multipath (after two
    warm-up steps), under torch.profiler: no kernel of PyTorch's
    advanced-indexing backward (index_put_ with accumulate: its
    indexing_backward* kernels, after a radix sort) runs; the
    material table's gradient comes from the lookup's kernel, once a pass,
    and K5's backward once."""
    from torch.profiler import ProfilerActivity, profile

    from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID
    from radarays_ros_tpu_torch.opti import optimize as O
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    mats = Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.1, ambient=0.5, diffuse=0.4, specular=60.0),
        dict(velocity=0.05, ambient=0.8, diffuse=0.2, specular=300.0)],
        device=dev)
    n_obj = int(small_scene.obj_ids.max()) + 1
    om = np.ones(n_obj, np.int32)
    om[0] = 2
    start = RadarParams.make(mats, om, beam_width_deg=8.0)
    cfg = RadarModelConfig(n_angles=64, n_cells=512, resolution=0.1,
                           n_samples=8, n_reflections=2, ambient_noise=0,
                           signal_denoising_triangular_width=15,
                           opaque_materials=False, record_multi_path=True,
                           trace_engine="kernel")
    gen = torch.Generator(dev).manual_seed(0)
    draws = tuple(torch.stack(d) for d in zip(*[
        sample_cone_draws(gen, 8, 2) for _ in range(2)]))
    poses = torch.from_numpy(np.stack([make_pose([0.5, 0.5, 2.0]),
                                       make_pose([-1.0, 0.5, 2.0])]))
    targets = torch.full((2, 512, 64), 3.0, device=dev)
    obj = O.default_objective(small_scene, cfg, poses, targets,
                              cone_draws=draws)
    pv = O.ParamVector(material_slots=(1, 2), tune_n_reflections=False)
    step_loss, _, to_z = O.step_loss_fn(obj, start, pv)
    z = to_z(pv.to_vec(start)).requires_grad_(True)
    opt = torch.optim.Adam([z], lr=0.04)

    def step():
        opt.zero_grad()
        loss = step_loss(z)
        loss.backward()
        loss.item()
        opt.step()

    step()
    step()
    torch.cuda.synchronize()
    t0, b0 = table_grad.launches, bin_bwd.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("table_grad_kernel" in x for x in names)
    assert not [x for x in names if "indexing_backward" in x]
    assert table_grad.launches - t0 == cfg.n_reflections
    assert bin_bwd.launches - b0 == 1
    assert torch.isfinite(z.grad).all() and z.grad.abs().max() > 0


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


# ------------------------------------------------------- the bench twins

_BENCH_SMALL = dict(n_angles=32, n_cells=1024, resolution=0.1, n_samples=8,
                    trace_ray_block=256)
_AT_HIER = ("sweep", "prep_hier", "coarse_words", "bin")


def _bench_lines(capsys):
    import json

    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _launched(rec, kernels, key="kernel_launches"):
    assert all(rec[key][k] > 0 for k in kernels), rec[key]


def test_bench_headline_on_card(dev, tmp_path, capsys):
    from radarays_ros_tpu_torch.bench import headline as H

    d = H.main(["--details", str(tmp_path / "d.json")],
               headline=dict(n_buildings=16600, extent=140.0),
               companions=(("small_10k", dict(n_buildings=800)),),
               cfg_overrides=_BENCH_SMALL,
               parity_kw=dict(n_buildings=1600, n_rays=40000))
    (line,) = _bench_lines(capsys)
    assert line["parity"]["exact"] is True and line["value"] > 0
    assert line["extra"]["device"].endswith(" W")       # name, power limit
    _launched(line["extra"], _AT_HIER)
    _launched(d["small_10k"], ("sweep", "prep_flat", "bin"))


def test_bench_engines_on_card(dev, capsys):
    from radarays_ros_tpu_torch.bench import engines as E

    b = BC.build_benchmark(800, device=dev)
    o, d = BC.on(dev, *BC.radar_fan(40000, el_std=0.03))
    res = E.trace_engines(b.scene, o, d, ["brute", "sweep", "kernel", "mxu"],
                          dev, n=2)
    want = res["brute"]["result"]
    for e in ("sweep", "kernel", "mxu"):
        assert torch.equal(res[e]["result"].hit, want.hit), e
        assert torch.equal(res[e]["result"].obj_id, want.obj_id), e
    recs = E.saturated(BC.build_benchmark(16600, 140.0, device=dev).scene,
                       dev, n_rays=131072)
    assert len(recs) == 4
    for r in recs:
        assert r["mrays_per_sec"] > 0 and r["peak_mib"] > 0
        _launched(r, ("sweep", "prep_hier", "coarse_words"))
    capsys.readouterr()


def test_bench_profile_frame_on_card(dev, capsys):
    from radarays_ros_tpu_torch.bench import profile_frame as PF

    p = PF.main(["--buildings", "16600"], cfg_overrides=_BENCH_SMALL)
    assert 0.0 <= p["device_idle_share"] < 1.0 and p["kernels"] > 0
    # K1's launches are grouped under its own name
    assert "sweep_kernel" in [g["op"] for g in p["top_groups"]]
    # the profiled batch replays the compiled frame: no host call of
    # bin_signals, K5 inside the graph (counted by _launched)
    assert p["bin_calls"] == 0
    _launched(p, _AT_HIER)
    capsys.readouterr()


def test_bench_opti_scale_on_card(dev, tmp_path, capsys):
    from radarays_ros_tpu_torch.bench import opti_scale as OS

    out = OS.main(["--steps", "4", "--frames", "2", "--checkpoint",
                   str(tmp_path / "ck.npz")],
                  cfg_overrides=dict(n_angles=32, n_cells=512, n_samples=4,
                                     trace_ray_block=256))
    g = out[2]
    assert g["resumed_from_step"] == 2 and np.isfinite(g["history"]).all()
    _launched(g, ("sweep", "prep_flat", "bin", "bin_bwd"))
    capsys.readouterr()


def test_bench_multichip_on_card(dev, capsys):
    from radarays_ros_tpu_torch.bench import multichip as MC

    out = MC.main(["--ranks", "2", "--iters", "2", "--buildings", "200"])
    lines = _bench_lines(capsys)
    assert all(ln["ranks_share_one_card"] is (torch.cuda.device_count() < 2)
               for ln in lines)
    assert [ln.get("bench") for ln in lines[1:]] == [
        "frame_sharded_1d_az", "frame_sharded_2d_az_smp"]
    for name in ("az", "az_smp"):
        _launched(out[name], ("sweep", "bin"))
        assert out[name]["frame"][0].max() > 0


@pytest.mark.parametrize("tc", [128, 384, 512])
def test_bench_ab_stages_on_card_at_chunk_size(dev, tc, capsys):
    """sweep_kernel_ab's stages at a chunk size chunksize_ab takes: the
    gate exact (K1 stages tc x 22 floats twice: 88 KiB at 512, past the
    default 48 KiB of dynamic shared memory), the marginal and the
    frame."""
    from radarays_ros_tpu_torch.bench import sweep_kernel_ab as SK

    recs = SK.stages(dev, chunk_size=tc, n_buildings=16600,
                     parity_kw=dict(n_buildings=16600, n_rays=40000),
                     marginal_kw=dict(n_rays=40000, k=3),
                     frame_kw=dict(n_iters=2, batch=4, n_stream=2),
                     cfg_overrides=_BENCH_SMALL, label={"chunk_size": tc})
    assert [r["stage"] for r in recs] == ["parity", "trace_marginal",
                                          "frame_1m"]
    assert recs[0]["exact"] is True and recs[0]["hit_mismatches"] == 0
    assert recs[1]["marginal_trace_ms"] > 0
    _launched(recs[2], _AT_HIER)
    capsys.readouterr()


def test_sweep_refuses_a_chunk_size_past_shared_memory(scene, dev):
    """A chunk size whose two K1 stages exceed the card's shared memory is
    refused by the wrapper before launch (chunksize_ab records it)."""
    tc = 2048
    o, d, bud = _fan(4096, dev)
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(scene, o, d, bud,
                                                    ray_block=2048, group=1)
    e, t_last = CT._run_prep(lo, hi, o, inv_d, bud, t_max=1000.0, RB=2048,
                             kernels=True)
    nvisit, order, entry = CT._rank(e[:, :C2])
    coef = torch.zeros(tc * 8, 22, device=dev)
    fetch = torch.zeros(tc * 8, 16, device=dev)
    box = torch.zeros(8, 3, device=dev)
    n0 = CT.sweep.launches
    with pytest.raises(CT.ChunkSizeRefused, match="shared memory"):
        CT.sweep(nvisit, order.clamp_max(7), entry, o, d, t_last, coef,
                 fetch, inv_d, bud, box, box, tc=tc, group=1, t_min=0.0,
                 t_max=1000.0)
    assert CT.sweep.launches == n0


def test_bench_make_demo_on_card(dev, tmp_path, capsys):
    from radarays_ros_tpu_torch.bench import make_demo as MD

    rec = MD.main(["--out", str(tmp_path)])
    polar, cart = (MD.read_back(f) for f in rec["files"])
    assert polar.shape == (3424, 400) and polar.max() > 0
    assert cart.shape == (800, 800, 3)
    capsys.readouterr()


def test_bench_order_ab_hw_on_card(dev, capsys):
    from radarays_ros_tpu_torch.bench import order_ab as OA

    recs = OA.main(["--hw", "--buildings", "16600", "--skip-frame",
                    "--skip-parity"])
    assert sorted({r["variant"] for r in recs}) == ["median", "sah"]
    for r in recs:
        if r["stage"] == "trace_marginal":
            assert r["marginal_trace_ms"] > 0
            _launched(r, ("sweep",))
    capsys.readouterr()


# ------------------------------------------------- the compiled frame

def _jit_case(small_scene, dev, **kw):
    """A small KAIST-like frame batch of 2 on the flat-prep scene: (cfg,
    params, poses on the card)."""
    from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    ids = small_scene.obj_ids
    n_obj = int(ids[ids != INVALID_OBJ_ID].max()) + 1
    params = RadarParams.make(Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)],
        device=dev), np.ones(n_obj, np.int32), 10.0)
    cfg = RadarModelConfig(**{**dict(
        n_angles=64, n_cells=512, resolution=0.1, n_samples=8,
        n_reflections=3, ambient_noise=2,
        signal_denoising_triangular_width=15, trace_engine="kernel"), **kw})
    poses = torch.from_numpy(np.stack([make_pose([0.5, 0.5, 2.0]),
                                       make_pose([-1.0, 0.5, 2.0])])).to(dev)
    return cfg, params, poses


def _frames_equal(a, b):
    """Bit for bit, field by field, on the host: a compiled entry on the
    card returns its u8 image there."""
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("engine", ["kernel", "mxu", "brute"])
def test_compiled_frames_equal_eager_on_card(small_scene, dev, engine):
    """simulate_frames_jit on the card: the first call captures (and returns
    the eager warm-up), the later ones replay the graph; every batch is the
    eager batch bit for bit on the same generator seed, with one capture."""
    from radarays_ros_tpu_torch.geom.scene import with_planes
    from radarays_ros_tpu_torch.sim import pipeline as P

    cfg, params, poses = _jit_case(small_scene, dev, trace_engine=engine)
    st = with_planes(small_scene) if engine == "mxu" else small_scene
    c0 = P.frame_graphs.captures
    for seed in range(3):
        got = P.simulate_frames_jit(
            st, params, cfg, poses,
            generator=torch.Generator(dev).manual_seed(seed))
        want = P.simulate_frames(
            st, params, cfg, poses,
            generator=torch.Generator(dev).manual_seed(seed))
        assert got.image_u8.max() > 0 and _frames_equal(got, want)
    assert P.frame_graphs.captures - c0 == 1
    assert P.frame_graphs.last().replays == 2


def test_compiled_frames_equal_eager_at_10m_on_the_route(dev):
    """portbench's kaist02-10m deployment, built as the benchmark builds it
    (9,960,002 triangles, 38,912 chunks: prep group 4 by the port's rule):
    a batch of 20 on the ring road's first poses through
    simulate_frames_jit (a capture, then a replay) bit for bit against
    simulate_frames; the capture and the replay each add one grouped K1
    launch a bounce and leave `last_group` at 4."""
    import json
    from pathlib import Path

    from portbench import system as S
    from portbench.generator import cone_draws
    from portbench.scene import loop_pose
    from radarays_ros_tpu_torch.sim import pipeline as P

    conf = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                       / "configs" / "kaist02-10m.json").read_text())
    system = S.build(conf, dev)
    st, cfg = system.scene, system.cfg
    assert st.n_chunks == 38_912 and CT._auto_prep_group(st.n_chunks) == 4
    params = S.port_params(S.material_table(conf["materials"], dev),
                           system.object_materials, conf["beam_width_deg"])
    tr = conf["trajectory"]
    poses = torch.from_numpy(loop_pose(
        np.radians(tr["phase_deg"]) + tr["step_m"] / tr["radius"]
        * np.arange(20), tr["radius"], tr["height"]))
    gen = torch.Generator(dev).manual_seed(3)
    c0 = P.frame_graphs.captures
    try:
        for _ in range(2):
            kw = dict(cone_draws=cone_draws(gen, 20, cfg),
                      random_begin=torch.randint(0, 1000, (20, cfg.n_angles),
                                                 generator=gen, device=dev))
            g0 = CT.sweep.grouped_launches
            got = P.simulate_frames_jit(st, params, cfg, poses, **kw)
            assert CT.sweep.grouped_launches - g0 == cfg.n_reflections
            assert CT.sweep.last_group == 4
            want = P.simulate_frames(st, params, cfg, poses.to(dev), **kw)
            assert got.image_u8.max() > 0 and _frames_equal(got, want)
        assert P.frame_graphs.captures - c0 == 1
        assert P.frame_graphs.last().replays == 1
    finally:
        P.frame_graphs.clear()


def test_compiled_frame_replays_new_values_without_capture(small_scene,
                                                           dev):
    """New poses, materials and beam width replay the graph (no capture)
    and give the eager frame for those values; a returned batch is not
    overwritten by the next call; a new cfg captures a second graph."""
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.sim.config import Materials

    cfg, params, poses = _jit_case(small_scene, dev)
    g = torch.Generator(dev).manual_seed(0)
    draws = tuple(torch.rand(2, 8, generator=g, device=dev) for _ in "tr")
    begin = torch.randint(0, 1000, (2, 64), generator=g, device=dev)
    kw = dict(cone_draws=draws, random_begin=begin)
    first = P.simulate_frames_jit(small_scene, params, cfg, poses, **kw)
    keep = [x.clone() for x in first]
    c0 = P.frame_graphs.captures
    m = params.materials
    params2 = params._replace(
        materials=Materials(m.velocity, m.ambient * 0.8, m.diffuse + 0.1,
                            m.specular * 0.5),
        beam_width=params.beam_width * 1.5)
    poses2 = poses + torch.tensor([0.7, -0.4, 0.0, 0, 0, 0, 0], device=dev)
    got = P.simulate_frames_jit(small_scene, params2, cfg, poses2, **kw)
    want = P.simulate_frames(small_scene, params2, cfg, poses2, **kw)
    assert P.frame_graphs.captures == c0
    assert _frames_equal(got, want) and not _frames_equal(got, first)
    assert _frames_equal(first, keep)
    P.simulate_frames_jit(small_scene, params, cfg.replace(signal_max=90.0),
                          poses, **kw)
    assert P.frame_graphs.captures == c0 + 1


@pytest.mark.parametrize("call", ["capture", "replay"])
@pytest.mark.parametrize("batch", [20, 1])
def test_compiled_frame_u8_lands_pinned_on_host(small_scene, dev, batch,
                                                call):
    """A compiled entry on the card (simulate_frames_jit at batch 20,
    simulate_frame_jit at 1), on the capturing call and on a replay,
    returns image_u8 as a page-locked host tensor, complete on return and
    bit for bit the eager frame's; a second call with other poses leaves
    the first call's image as it was and fills another buffer; each call
    counts one fetch of N x n_cells x n_angles bytes; image_float and
    max_val stay on the card."""
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    P.frame_graphs.clear()
    cfg, params, _ = _jit_case(small_scene, dev)
    poses = torch.from_numpy(np.stack([make_pose([0.5 - 0.1 * f, 0.5, 2.0])
                                       for f in range(batch)])).to(dev)
    g = torch.Generator(dev).manual_seed(batch)

    def inputs():
        return dict(cone_draws=tuple(torch.rand(batch, 8, generator=g,
                                                device=dev) for _ in "tr"),
                    random_begin=torch.randint(0, 1000, (batch, 64),
                                               generator=g, device=dev))

    def run(frames, frame, poses, kw):
        if batch > 1:
            return frames(small_scene, params, cfg, poses, **kw)
        return frame(small_scene, params, cfg, poses[0],
                     cone_draws=tuple(d[0] for d in kw["cone_draws"]),
                     random_begin=kw["random_begin"][0])

    def compiled(poses, kw):
        return run(P.simulate_frames_jit, P.simulate_frame_jit, poses, kw)

    def fetched():
        return (P.simulate_frames_jit.host_fetches,
                P.simulate_frames_jit.host_fetch_bytes)

    if call == "replay":
        compiled(poses, inputs())
    c0, (n0, b0) = P.frame_graphs.captures, fetched()
    kw = inputs()
    got = compiled(poses, kw)
    assert P.frame_graphs.captures - c0 == (call == "capture")
    u8 = got.image_u8
    assert u8.device.type == "cpu" and u8.is_pinned()
    assert got.image_float.is_cuda and got.max_val.is_cuda
    want = run(P.simulate_frames, P.simulate_frame, poses, kw)
    assert want.image_u8.is_cuda
    assert u8.max() > 0 and torch.equal(u8, want.image_u8.cpu())
    nbytes = batch * cfg.n_cells * cfg.n_angles
    assert u8.numel() == nbytes
    assert fetched() == (n0 + 1, b0 + nbytes)
    keep = u8.clone()
    other = compiled(poses + torch.tensor([0.7, -0.4, 0.0, 0, 0, 0, 0],
                                          device=dev), inputs())
    assert fetched() == (n0 + 2, b0 + 2 * nbytes)
    assert other.image_u8.is_pinned()
    assert other.image_u8.data_ptr() != u8.data_ptr()
    assert torch.equal(u8, keep) and not torch.equal(other.image_u8, u8)
    P.frame_graphs.clear()


def test_radar_compiled_frames_follow_new_object_materials(dev):
    """Radar.load_materials bakes a new scene (the per-triangle material
    column) every time, and the old one is dropped: each compiled frame
    after a change is the eager frame of the new scene, bit for bit, so
    no graph reads a freed or an earlier scene's tables."""
    import gc

    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.sim.config import RadarModelConfig
    from radarays_ros_tpu_torch.sim.radar import Radar
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    parts, names = make_urban_scene(n_buildings=20, extent=40.0, seed=1)
    scene = Scene.compose(parts, names, chunk_size=64)
    cfg = RadarModelConfig(n_angles=64, n_cells=512, resolution=0.1,
                           n_samples=8, n_reflections=3, ambient_noise=0,
                           signal_denoising_triangular_width=15,
                           trace_engine="kernel")
    radar = Radar(scene, cfg=cfg, device=dev)
    mats = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
            dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0),
            dict(velocity=0.0, ambient=0.3, diffuse=0.6, specular=20.0)]
    n_obj = radar.params.object_materials.shape[0]
    pose = make_pose([0.5, 0.5, 2.0])
    frames = []
    for i in range(5):
        radar.load_materials(mats, (np.arange(n_obj) + i) % 2 + 1)
        gc.collect()
        torch.cuda.empty_cache()
        got = radar.simulate(pose)
        want = P.simulate_frame(radar._scene_tensors, radar.params,
                                radar.cfg, torch.as_tensor(pose),
                                cone_draws=radar._cone_draws)
        assert got.image_u8.max() > 0 and _frames_equal(got, want), i
        frames.append(got)
    assert not _frames_equal(frames[0], frames[1])
    assert _frames_equal(frames[0], frames[2])


def test_compiled_frame_launch_counts_move_on_replay(small_scene, dev):
    """The wrappers' counts move on every replay by the launches recorded
    at capture (and not by the capture itself), and the profiler sees those
    kernels in one replay."""
    from torch.profiler import ProfilerActivity, profile

    from radarays_ros_tpu_torch.sim import graphs as G
    from radarays_ros_tpu_torch.sim import pipeline as P

    cfg, params, poses = _jit_case(small_scene, dev, signal_max=100.0)
    g = torch.Generator(dev).manual_seed(0)
    P.simulate_frames_jit(small_scene, params, cfg, poses, generator=g)
    graph = P.frame_graphs.last()
    per = graph.launches
    assert per["prep_flat"] == per["sweep"] == cfg.n_reflections
    assert per["bin"] == 1 and "bin_bwd" not in per
    before = G.launch_counts()
    for _ in range(2):
        P.simulate_frames_jit(small_scene, params, cfg, poses, generator=g)
    after = G.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {k: 2 * n for k, n in per.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        P.simulate_frames_jit(small_scene, params, cfg, poses, generator=g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for k, kern in (("sweep", "sweep_kernel"), ("prep_flat",
                                                "prep_flat_kernel"),
                    ("bin", "bin_kernel")):
        assert sum(kern in x for x in names) == per[k], k


def test_compiled_value_and_grad_on_card(small_scene, dev):
    """The fit's compiled value-and-grad on the card: loss and gradient bit
    for bit against the eager step over three Adam steps, K5's backward and
    table_grad inside the graph, Adam eager."""
    from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID
    from radarays_ros_tpu_torch.opti import optimize as O
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    ids = small_scene.obj_ids
    n_obj = int(ids[ids != INVALID_OBJ_ID].max()) + 1
    start = RadarParams.make(Materials.from_list([
        dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        dict(velocity=0.1, ambient=0.5, diffuse=0.4, specular=60.0),
        dict(velocity=0.0, ambient=0.9, diffuse=0.1, specular=200.0)],
        device=dev), np.ones(n_obj, np.int32), 8.0)
    cfg = RadarModelConfig(n_angles=64, n_cells=512, resolution=0.1,
                           n_samples=8, n_reflections=2, ambient_noise=0,
                           signal_denoising_triangular_width=15,
                           opaque_materials=False, record_multi_path=True,
                           trace_engine="kernel")
    gen = torch.Generator(dev).manual_seed(0)
    draws = tuple(torch.stack(d) for d in zip(*[
        sample_cone_draws(gen, 8, 2) for _ in range(2)]))
    poses = torch.from_numpy(np.stack([make_pose([0.5, 0.5, 2.0]),
                                       make_pose([-1.0, 0.5, 2.0])]))
    targets = torch.full((2, 512, 64), 3.0, device=dev)
    obj = O.default_objective(small_scene, cfg, poses, targets,
                              cone_draws=draws)
    pv = O.ParamVector(material_slots=(1, 2), tune_n_reflections=False)
    step_loss, _, to_z = O.step_loss_fn(obj, start, pv)
    grad_fn = O.value_and_grad(step_loss)
    z_c = to_z(pv.to_vec(start)).requires_grad_(True)
    z_e = z_c.detach().clone().requires_grad_(True)
    opt_c = torch.optim.Adam([z_c], lr=0.04)
    opt_e = torch.optim.Adam([z_e], lr=0.04)
    for _ in range(3):
        val, g = grad_fn(z_c)
        opt_e.zero_grad()
        loss = step_loss(z_e)
        loss.backward()
        assert torch.equal(val, loss.detach()) and torch.equal(g, z_e.grad)
        assert torch.isfinite(g).all() and g.abs().max() > 0
        z_c.grad = g
        opt_c.step()
        opt_e.step()
    graph = grad_fn.last()
    assert graph.replays == 2
    assert graph.launches["bin_bwd"] == 1
    assert graph.launches["table_grad"] == cfg.n_reflections
    assert graph.launches["prep_flat"] > 0 and graph.launches["sweep"] > 0


def test_compiled_frame_refuses_the_plain_sweep(small_scene, dev):
    """The plain "sweep" engine ends its loop on a host test: the compiled
    entry refuses it by its config, before anything runs."""
    from radarays_ros_tpu_torch.sim import pipeline as P

    cfg, params, poses = _jit_case(small_scene, dev, trace_engine="sweep")
    n0, c0 = CT.prep_flat.launches, P.frame_graphs.captures
    with pytest.raises(P.JitRefused, match="sweep"):
        P.simulate_frames_jit(small_scene, params, cfg, poses,
                              generator=torch.Generator(dev).manual_seed(0))
    assert CT.prep_flat.launches == n0 and P.frame_graphs.captures == c0


def test_compiled_frame_raises_on_a_capture_a_sync_breaks(small_scene, dev,
                                                          monkeypatch):
    """The positive control: a host sync in the frame (.item() after the
    binning) passes the eager warm-up and breaks the capture, and the
    compiled entry raises — it does not fall back to the eager frame."""
    from radarays_ros_tpu_torch.sim import pipeline as P

    draw = P.draw_signals

    def synced(*a, **k):
        img, mv = draw(*a, **k)
        mv.max().item()
        return img, mv

    monkeypatch.setattr(P, "draw_signals", synced)
    cfg, params, poses = _jit_case(small_scene, dev, signal_max=80.0)
    c0 = P.frame_graphs.captures
    with pytest.raises(RuntimeError):
        P.simulate_frames_jit(small_scene, params, cfg, poses,
                              generator=torch.Generator(dev).manual_seed(0))
    assert P.frame_graphs.captures == c0
    torch.cuda.synchronize()
