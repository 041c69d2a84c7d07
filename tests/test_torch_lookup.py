"""The frame's material lookup (radarays_ros_tpu_torch.sim.lookup) on the
CPU: its forward bit-identical to the four column gathers it stands for
(radarays_ros_tpu/sim/pipeline.py:69-77, 175), its backward the plain
version of the kernel rr_table_grad — bitwise in the kernel's summation
order, and within 1e-6 x sum|g| of index_add_ and of the autograd of
advanced indexing — the material cap refused with its own exception, and
frames and the fit through the lookup against the JAX package. The kernel
itself is held to this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.sim.pipeline import simulate_frame_jit

from radarays_ros_tpu_torch.opti import optimize as O
from radarays_ros_tpu_torch.sim.config import Materials, RadarModelConfig
from radarays_ros_tpu_torch.sim.lookup import (MAX_MATERIALS,
                                               MaterialCapRefused,
                                               _table_grad_plain,
                                               material_lookup, table_grad)
from radarays_ros_tpu_torch.sim.pipeline import (float_u8_image,
                                                 simulate_frames)
from radarays_ros_tpu_torch.utils.transforms import make_pose

from test_torch_pipeline import (_CFG, _MATS, _MATS_T, _assert_frame_contract,
                                 _both_params, _inputs, _jx_cfg, world)  # noqa: F401

torch.set_num_threads(2)


def _table(M, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(0.0, 0.3, M), rng.uniform(0.0, 1.0, M),
            rng.uniform(0.0, 1.0, M), rng.uniform(1.0, 3000.0, M)]
    return Materials(*(torch.from_numpy(c.astype(np.float32)) for c in cols))


def _rows(n, M, seed, shape=None):
    """n material ids in [0, M) (a few of every id, runs of one id) and an
    (n, 4) cotangent with signed zeros and a wide range of magnitudes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, M, n)
    idx[: n // 3] = rng.integers(0, M) if M else 0          # a long run
    g = (rng.normal(size=(n, 4)) * 10.0 ** rng.integers(-3, 4, (n, 4)))
    g = g.astype(np.float32)
    g[rng.uniform(size=(n, 4)) < 0.1] = -0.0
    g[rng.uniform(size=(n, 4)) < 0.1] = 0.0
    idx = torch.from_numpy(idx)
    return (idx if shape is None else idx.reshape(shape)), torch.from_numpy(g)


def _kernel_order(idx, g, M):
    """rr_table_grad's sum written out from its thread mapping in NumPy:
    row q = b * 1024 + e * 256 + w * 32 + l of slice b is lane l of warp w's
    e-th row; (v0 + v2) + (v1 + v3) a lane, __shfl_down_sync halving over
    the lanes, halving over the 8 warps' bins, the slices in order."""
    idx, g = idx.numpy().reshape(-1), g.numpy().reshape(-1, 4)
    n = idx.shape[0]
    nb = -(-n // 1024)
    w, lane = np.arange(8)[:, None], np.arange(32)[None, :]
    part = np.zeros((nb, M, 4), np.float32)
    for b in range(nb):
        for m in range(M):
            v = []
            for e in range(4):
                q = b * 1024 + e * 256 + w * 32 + lane           # (8, 32)
                inside = q < n
                hit = inside & (idx[np.where(inside, q, 0)] == m)
                v.append(np.where(hit[..., None],
                                  g[np.where(inside, q, 0)], np.float32(0)))
            x = (v[0] + v[2]) + (v[1] + v[3])                   # (8, 32, 4)
            off = 16
            while off:                   # lane l takes lane l + off's sum
                x = np.concatenate([x[:, :off] + x[:, off:2 * off],
                                    x[:, off:]], 1)
                off //= 2
            bins = x[:, 0]                                      # (8, 4)
            h = 4
            while h:
                bins = bins[:h] + bins[h:2 * h]
                h //= 2
            part[b, m] = bins[0]
    if nb == 0:
        return np.zeros((M, 4), np.float32)
    acc = part[0]
    for b in range(1, nb):
        acc = acc + part[b]
    return acc


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("shape", [(7,), (3, 40, 11), (2, 400, 50)])
def test_lookup_forward_bit_identical_to_column_gathers(shape):
    """One gather of the stacked table returns the bits of the reference's
    four column gathers, with and without a gradient on the table."""
    mats = _table(5, 0)
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 5, shape))
    want = torch.stack([c[idx] for c in mats], -1)
    assert torch.equal(material_lookup(mats, idx).view(torch.int32),
                       want.view(torch.int32))
    leaves = Materials(*(c.clone().requires_grad_(True) for c in mats))
    got = material_lookup(leaves, idx)
    assert got.shape == (*shape, 4) and got.requires_grad
    assert torch.equal(got.detach().view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.parametrize("n,M", [(0, 3), (1, 1), (1000, 3), (1024, 3),
                                 (1025, 7), (5000, 3), (3100, 256)])
def test_table_grad_plain_is_the_kernel_order(n, M):
    """_table_grad_plain returns the bits of the kernel's summation order
    written out from its thread mapping, at slice edges (1,024 rows),
    ragged tails and the material cap."""
    idx, g = _rows(n, M, seed=n + M)
    got = _table_grad_plain(idx, g, M)
    assert got.shape == (M, 4)
    np.testing.assert_array_equal(_bits(got), _bits(_kernel_order(idx, g,
                                                                   M)))


def _per_entry_sum_abs(idx, g, M):
    out = torch.zeros((M, 4), dtype=torch.float64)
    return out.index_add_(0, idx.reshape(-1), g.reshape(-1, 4).abs()
                          .double())


@pytest.mark.parametrize("n,M", [(60000, 3), (120000, 3), (20000, 256)])
def test_table_grad_within_index_add_and_advanced_indexing(n, M):
    """The table gradient at the fit's row counts (3 frames x 400 azimuths
    x 50 samples, doubled on pass 2) within 1e-6 x sum|g| per entry of
    index_add_ and of the autograd of advanced indexing (each sums the rows
    in another f32 order)."""
    idx, g = _rows(n, M, seed=M)
    got = table_grad(idx, g, M)
    tol = (1e-6 * _per_entry_sum_abs(idx, g, M)).float()
    lib = torch.zeros((M, 4)).index_add_(0, idx, g)
    table = torch.zeros((M, 4), requires_grad=True)
    table[idx].backward(g)
    for want in (lib, table.grad):
        assert ((got - want).abs() <= tol).all()
    assert (got != 0).sum() >= min(M, 3) * 4


def test_lookup_backward_is_table_grad():
    """The gradient of a loss through material_lookup on the table's four
    columns is _table_grad_plain's, bit for bit, and within 1e-6 x sum|g|
    of the autograd of the four column gathers."""
    mats = _table(4, 2)
    idx, g = _rows(3 * 40 * 11, 4, seed=3, shape=(3, 40, 11))
    g = g.reshape(3, 40, 11, 4)

    def grads(fn):
        leaves = [c.clone().requires_grad_(True) for c in mats]
        fn(Materials(*leaves)).backward(g)
        return torch.stack([c.grad for c in leaves], -1)

    got = grads(lambda m: material_lookup(m, idx))
    want = _table_grad_plain(idx, g, 4)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = grads(lambda m: torch.stack([c[idx] for c in m], -1))
    tol = (1e-6 * _per_entry_sum_abs(idx, g, 4)).float()
    assert ((got - ref).abs() <= tol).all() and got.abs().max() > 0


def test_material_cap_refused():
    """A table of more than MAX_MATERIALS rows is refused with its own
    exception when it needs a gradient (before any frame runs), and by the
    table gradient itself; a frame without one takes any table."""
    big = _table(MAX_MATERIALS + 1, 4)
    idx = torch.arange(MAX_MATERIALS + 1)
    assert material_lookup(big, idx).shape == (MAX_MATERIALS + 1, 4)
    leaves = Materials(*(c.clone().requires_grad_(True) for c in big))
    with pytest.raises(MaterialCapRefused, match=str(MAX_MATERIALS)):
        material_lookup(leaves, idx)
    with pytest.raises(MaterialCapRefused):
        table_grad(idx, torch.ones(idx.shape[0], 4), MAX_MATERIALS + 1)
    assert issubclass(MaterialCapRefused, ValueError)
    at_cap = Materials(*(c[:MAX_MATERIALS].clone().requires_grad_(True)
                         for c in big))
    material_lookup(at_cap, idx[:MAX_MATERIALS]).sum().backward()
    assert torch.equal(at_cap.velocity.grad, torch.ones(MAX_MATERIALS))


_KAIST_SMALL = dict(
    n_angles=16, n_cells=128, resolution=0.25, n_samples=6, n_reflections=3,
    beam_sample_dist=2, beam_sample_dist_normal_p_in_cone=0.8,
    energy_max=0.72, signal_max=110.0, signal_denoising=1,
    signal_denoising_triangular_width=35,
    signal_denoising_triangular_mode=0.35, ambient_noise=2,
    ambient_noise_at_signal_0=0.1, ambient_noise_at_signal_1=0.03,
    ambient_noise_energy_max=0.1, ambient_noise_energy_min=0.05,
    record_multi_reflection=True, record_multi_path=False,
    opaque_materials=True, trace_ray_block=128)


@pytest.mark.parametrize("frame", ["refraction_tree", "kaist_opaque"])
def test_frames_through_the_lookup_match_reference(world, frame):
    """A refraction-tree frame with multipath (the lookup on every pass,
    read by both returns) and a KAIST-preset opaque frame (its physics at a
    CPU size), two poses a batch through simulate_frames with the table
    requiring a gradient, each frame within the frame contract of the JAX
    simulate_frame_jit (tests/test_oracle.py:70-87)."""
    _, st, _, sa, _ = world
    if frame == "refraction_tree":
        kw = dict(opaque_materials=False, record_multi_path=True,
                  multipath_threshold=0.3)
        jparams, params = _both_params(_MATS_T)
        cfg, jcfg = RadarModelConfig(**{**_CFG, **kw}), _jx_cfg(**kw)
    else:
        jparams, params = _both_params(_MATS)
        cfg = RadarModelConfig(**_KAIST_SMALL)
        from radarays_ros_tpu.sim import config as JCFG
        jcfg = JCFG.RadarModelConfig(**_KAIST_SMALL, trace_engine="pallas3",
                                     draw_method="pallas")
    params = params._replace(materials=Materials(
        *(c.clone().requires_grad_(True) for c in params.materials)))
    poses = np.stack([make_pose([0.5, -0.3, 1.0]),
                      make_pose([-2.0, 1.5, 1.2], [0, 0, 0.2588, 0.9659])])
    keys = [jax.random.PRNGKey(11 + i) for i in range(2)]
    refs = [simulate_frame_jit(sa, jparams, jcfg, jnp.asarray(p),
                               tuple(jax.random.split(k)))
            for p, k in zip(poses, keys)]
    dirs, begin = zip(*[_inputs(k, cfg, jparams.beam_width) for k in keys])
    got = simulate_frames(st, params, cfg, torch.from_numpy(poses),
                          local_dirs=torch.from_numpy(np.stack(dirs)),
                          random_begin=torch.from_numpy(np.stack(begin)))
    assert got.image_float.requires_grad
    for i, ref in enumerate(refs):
        _assert_frame_contract(got.image_float[i].detach(),
                               got.max_val[i].detach(), got.image_u8[i],
                               ref.image_float, ref.max_val, ref.image_u8)


def _graph_nodes(t):
    """The names of the autograd nodes behind t."""
    names, seen, stack = [], set(), [t.grad_fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.append(type(f).__name__)
        stack.extend(nf for nf, _ in f.next_functions)
    return names


@pytest.mark.parametrize("multipath", [False, True])
def test_fit_step_has_no_index_backward(world, multipath):
    """The fit's loss (opti_scale's refraction tree, 2 reflections) reaches
    the material table through one lookup a pass and no advanced-indexing
    backward (IndexBackward0: on the card, PyTorch's sorting index_put_
    kernels); its gradient is finite and moves the tuned materials."""
    _, st, _, _, _ = world
    jparams, start = _both_params(_MATS_T)
    cfg = RadarModelConfig(**{**_CFG, "opaque_materials": False,
                              "n_reflections": 2, "ambient_noise": 0,
                              "record_multi_path": multipath,
                              "multipath_threshold": 0.3})
    poses = torch.from_numpy(np.stack([make_pose([0.5, -0.3, 1.0])] * 2))
    gen = torch.Generator().manual_seed(0)
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws
    draws = tuple(torch.stack(d) for d in zip(*[
        sample_cone_draws(gen, cfg.n_samples, cfg.beam_sample_dist)
        for _ in range(2)]))
    with torch.no_grad():
        targets = float_u8_image(simulate_frames(
            st, start, cfg, poses, cone_draws=draws), cfg) * 0.5
    pv = O.ParamVector(material_slots=(1, 2), tune_n_reflections=False)
    obj = O.default_objective(st, cfg, poses, targets, cone_draws=draws)
    step_loss, _, to_z = O.step_loss_fn(obj, start, pv)
    z = to_z(pv.to_vec(start)).requires_grad_(True)
    loss = step_loss(z)
    nodes = _graph_nodes(loss)
    assert "IndexBackward0" not in nodes
    assert nodes.count("_LookupBackward") == cfg.n_reflections
    loss.backward()
    assert torch.isfinite(z.grad).all() and z.grad[1:].abs().max() > 0
