"""The port's CUDA kernels against their plain torch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
(sm_90a) with nvcc; without torch.cuda they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

Every kernel must agree with its plain version bit for bit: both round
every product and sum separately, in the same order (-fmad=false build).
"""

import numpy as np
import pytest
import torch

from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
from radarays_ros_tpu_torch.geom.scene import Scene
from radarays_ros_tpu_torch.image.cuda_draw import _bin_plain, bin_signals
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


@pytest.mark.parametrize("rb", [2048, 768, 128])
def test_prep_and_sweep_kernels_equal_plain(scene, dev, rb):
    o, d, bud = _fan(8192 + 77, dev)
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(scene, o, d, bud,
                                                    ray_block=rb, group=1)
    rbt = next(r for r in (1024, 512, 256, 128) if rb % r == 0)
    slo, shi = CT._coarse_boxes(lo, hi)
    w_k = CT.coarse_words(slo, shi, o, inv_d, bud, 1000.0, rbt)
    w_p = CT._coarse_words_plain(slo, shi, o, inv_d, bud, 1000.0, rbt)
    assert torch.equal(w_k, w_p) and (w_k != 0).any()
    e_k, t_k = CT.prep_hier(w_k, lo, hi, o, inv_d, bud, 1000.0, rb, rbt)
    e_p, t_p = CT._prep_plain(lo, hi, o, inv_d, bud, 1000.0, rb, rbt, w_k)
    assert torch.equal(e_k, e_p) and torch.equal(t_k, t_p)
    nvisit, order, entry = CT._rank(e_k[:, :C2])
    args = (nvisit, order, entry, o, d, t_k, scene.coef, scene.fetch)
    kw = dict(tc=scene.chunk_size, group=1, t_min=0.0)
    bt_k, bi_k, rows_k = CT.sweep(*args, **kw)
    bt_p, bi_p, rows_p = CT._sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(bt_k, bt_p)
    assert torch.equal(bi_k, bi_p)
    assert torch.equal(rows_k, rows_p)
    assert torch.isfinite(bt_k).float().mean() > 0.3


def test_kernel_engine_matches_brute(scene, dev):
    o, d, bud = _fan(2048, dev, seed=1)
    got = trace(scene, o, d, engine="kernel", t_budget=bud)
    ref = trace(scene, o, d, engine="brute", t_budget=bud)
    hit = ref.hit
    assert torch.equal(hit, got.hit)
    assert torch.equal(ref.obj_id, got.obj_id)
    torch.testing.assert_close(got.t[hit], ref.t[hit], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("combine", ["sum", "max"])
def test_bin_kernel_equals_plain(dev, combine):
    rng = np.random.default_rng(2)
    A, N, n_cells = 400, 200, 3424
    cell = rng.integers(-5, n_cells + 5, (A, N)).astype(np.int32)
    cell[:, :40] = rng.integers(0, 8, (A, 40))          # duplicate cells
    s = rng.exponential(1.0, (A, N)).astype(np.float32)
    cell_t = torch.from_numpy(cell).to(dev)
    s_t = torch.from_numpy(s).to(dev)
    w, mode = build_denoiser(1, 35, 0.35) if combine == "sum" else (None, 0)
    got = bin_signals(cell_t, s_t, n_cells=n_cells, combine=combine,
                      weights=w, w_mode=mode)
    want = _bin_plain(cell_t, s_t, n_cells=n_cells, combine=combine,
                      weights=w, w_mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_small_scene_kernel_path_raises_for_flat_prep(dev):
    parts, names = make_urban_scene(n_buildings=20, extent=40.0, seed=1)
    st = Scene.compose(parts, names, chunk_size=64).to_device(dev)
    o, d, _ = _fan(256, dev)
    with pytest.raises(NotImplementedError, match="K4"):
        trace(st, o, d, engine="kernel")
    res = trace(st, o, d, engine="sweep")     # the plain path still runs
    assert res.hit.any()
