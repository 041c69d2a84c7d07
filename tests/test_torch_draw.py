"""The port's image stage (radarays_ros_tpu_torch.image) against the JAX
package: denoise taps bit-identical; the plain K5 bin's serial sum and max
bit-equal to the reference's Pallas kernel in interpret mode, its tap stage
within 2 ulp (see _TAP_RTOL); draw, noise, Perlin and u8 normalization
against the reference functions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.image import denoise as JD
from radarays_ros_tpu.image import draw as JDR
from radarays_ros_tpu.image.pallas_draw import bin_signals_pallas
from radarays_ros_tpu.image.perlin import perlin_affine_rows as jx_perlin

from radarays_ros_tpu_torch.image import denoise as D
from radarays_ros_tpu_torch.image import draw as DR
from radarays_ros_tpu_torch.image.cuda_draw import (_bin_bwd,
                                                    _bin_bwd_signals,
                                                    _bin_plain, bin_signals)
from radarays_ros_tpu_torch.image.perlin import perlin_affine_rows

torch.set_num_threads(2)


@pytest.mark.parametrize("mode_enum,width,frac", [
    (1, 35, 0.35), (1, 50, 0.35), (2, 9, 0.45), (3, 9, 0.45), (3, 50, 0.4),
    (1, 7, 0.0)])
def test_denoiser_taps_bit_identical(mode_enum, width, frac):
    w, m = D.build_denoiser(mode_enum, width, frac)
    jw, jm = JD.build_denoiser(mode_enum, width, frac)
    assert m == jm
    np.testing.assert_array_equal(w, jw)


def _signals(A, N, n_cells, seed):
    rng = np.random.default_rng(seed)
    cell = rng.integers(-3, n_cells + 4, size=(A, N)).astype(np.int32)
    # duplicates on purpose: several signals per cell exercise sum order
    cell[:, : N // 4] = rng.integers(0, 6, size=(A, N // 4))
    s = rng.exponential(1.0, size=(A, N)).astype(np.float32)
    ok = (cell >= 0) & (cell < n_cells)
    return np.where(ok, cell, n_cells).astype(np.int32), s, ok


# Tap sums: the port rounds every product and sum separately (its CUDA
# kernel is built with -fmad=false, so kernel and plain version agree bit
# for bit on the card). The reference's interpret-mode kernel is lowered by
# XLA:CPU, which contracts some of the W multiply-adds into FMAs, chosen per
# fusion — about a fifth of the taps' outputs differ from either all-FMA or
# no-FMA evaluation in the last bit. The tap stage is therefore held to
# 2 ulp (rtol 2.4e-7); the serial point sum and the max are bit-equal.
_TAP_RTOL = 2.4e-7


def _bin_fixture():
    w, mode = D.build_denoiser(1, 35, 0.35)
    cell, s, ok = _signals(16, 200, 300, seed=0)
    return w, mode, cell, np.where(ok, s, 0.0).astype(np.float32)


def test_bin_point_sum_bit_equal_to_pallas_kernel():
    _, _, cell, s = _bin_fixture()
    got = bin_signals(torch.from_numpy(cell), torch.from_numpy(s),
                      n_cells=300, combine="sum")
    ref = bin_signals_pallas(jnp.asarray(cell), jnp.asarray(s), n_cells=300,
                             combine="sum", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bin_with_taps_matches_pallas_kernel():
    w, mode, cell, s = _bin_fixture()
    got = bin_signals(torch.from_numpy(cell), torch.from_numpy(s),
                      n_cells=300, combine="sum", weights=w, w_mode=mode)
    ref = bin_signals_pallas(jnp.asarray(cell), jnp.asarray(s), n_cells=300,
                             combine="sum", weights=tuple(map(float, w)),
                             w_mode=mode, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=_TAP_RTOL,
                               atol=0)
    # the same taps with every product and sum rounded once, in NumPy
    point = _bin_plain(torch.from_numpy(cell), torch.from_numpy(s),
                       n_cells=300, combine="sum").numpy()
    W = len(w)
    padded = np.pad(point, ((0, 0), (W - 1, W - 1)))
    want = np.zeros_like(point)
    for k in range(W):
        off = (W - 1) - (k - mode)
        want = want + np.float32(w[k]) * padded[:, off:off + 300]
    np.testing.assert_array_equal(got.numpy(), want)


def test_bin_max_bit_equal_to_pallas_kernel():
    cell, s, ok = _signals(12, 64, 100, seed=1)
    s = np.where(ok, s - 0.5, -np.inf).astype(np.float32)   # some negative
    got = bin_signals(torch.from_numpy(cell), torch.from_numpy(s),
                      n_cells=100, combine="max")
    ref = bin_signals_pallas(jnp.asarray(cell), jnp.asarray(s), n_cells=100,
                             combine="max", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="combine='sum'"):
        bin_signals(torch.from_numpy(cell), torch.from_numpy(s), n_cells=100,
                    combine="max", weights=np.ones(3, np.float32))


def _times(A, N, seed, n_cells, res):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1.0, (n_cells + 10) * res / 0.15, (A, N)) \
        .astype(np.float32)
    s = rng.exponential(1.0, (A, N)).astype(np.float32)
    v = rng.uniform(size=(A, N)) < 0.8
    return t, s, v


@pytest.mark.parametrize("denoise", [True, False])
def test_draw_signals_match_reference(denoise):
    n_cells, res = 200, 0.25
    t, s, v = _times(10, 60, 2, n_cells, res)
    w, mode = D.build_denoiser(1, 9, 0.45) if denoise else (None, 0)
    img, mv = DR.draw_signals(torch.from_numpy(t), torch.from_numpy(s),
                              torch.from_numpy(v), n_cells=n_cells,
                              resolution=res, denoise_weights=w,
                              denoise_mode=mode)
    rimg, rmv = JDR.draw_signals(jnp.asarray(t), jnp.asarray(s),
                                 jnp.asarray(v), n_cells=n_cells,
                                 resolution=res, denoise_weights=w,
                                 denoise_mode=mode, method="pallas")
    rtol = _TAP_RTOL if denoise else 0.0
    np.testing.assert_allclose(img.numpy(), np.asarray(rimg), rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(mv.numpy(), np.asarray(rmv), rtol=rtol,
                               atol=0)
    plain, _ = DR.draw_signals(torch.from_numpy(t), torch.from_numpy(s),
                               torch.from_numpy(v), n_cells=n_cells,
                               resolution=res, denoise_weights=w,
                               denoise_mode=mode, method="plain")
    np.testing.assert_array_equal(img.numpy(), plain.numpy())


@pytest.mark.parametrize("scale", [0.05, 0.2, 0.37])
def test_perlin_rows_match_reference(scale):
    rng = np.random.default_rng(3)
    x0 = rng.integers(0, 1000, 24)
    y = (np.arange(24) * scale).astype(np.float32)
    got = perlin_affine_rows(torch.from_numpy(x0), torch.from_numpy(y),
                             scale, 500)
    ref = jx_perlin(jnp.asarray(x0), jnp.asarray(y), scale, 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", [1, 2])
def test_ambient_noise_and_u8_match_reference(mode):
    A, n_cells, res = 16, 256, 0.1
    rng = np.random.default_rng(4)
    img = rng.exponential(1.0, (A, n_cells)).astype(np.float32)
    img[3] = 0.0                                    # an empty column
    mv = img.max(axis=1)
    img = img * np.float32(0.72)
    cols = (5 + np.arange(A)) % A
    key = jax.random.PRNGKey(7)
    kw = dict(mode=mode, resolution=res, at_signal_0=0.1, at_signal_1=0.03,
              energy_max=0.1, energy_min=0.05, energy_loss=0.05)
    ref = JDR.apply_ambient_noise(jnp.asarray(img), jnp.asarray(mv),
                                  jnp.asarray(cols), key, **kw)
    # the reference's own field derivation (PRNG streams are inputs here)
    k_begin, k_uni = jax.random.split(key)
    begin = np.array(jax.random.randint(k_begin, (A,), 0, 1000))
    uni = np.array(jax.random.uniform(k_uni, (A, n_cells), jnp.float32))
    got = DR.apply_ambient_noise(
        torch.from_numpy(img), torch.from_numpy(mv), torch.from_numpy(cols),
        random_begin=torch.from_numpy(begin), uniform=torch.from_numpy(uni),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    u8 = DR.normalize_to_u8(got, torch.from_numpy(mv), 110.0)
    ru8 = JDR.normalize_to_u8(ref, jnp.asarray(mv), 110.0)
    diff = np.abs(u8.numpy().astype(int) - np.asarray(ru8).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    assert (u8.numpy()[3] == 0).all()


def test_bin_cells_matches_reference():
    t = np.linspace(-1.0, 500.0, 1001).astype(np.float32)
    np.testing.assert_array_equal(
        DR.bin_cells(torch.from_numpy(t), 0.0595238).numpy(),
        np.asarray(JDR.bin_cells(jnp.asarray(t), 0.0595238)))


def _grad_case(case):
    """(cell, s, bin kwargs) for the K5 gradient tests: taps, plain sum, or
    max with some negative strengths; and the backward's edge cases: every
    cell within a tap window of either end, 0 and n_cells - 1 among them
    and -1 and n_cells beside them ("edges"); three signals in four invalid ("invalid"); max with
    ties in every touched cell ("max_ties"); one tap ("w1"); 256 taps, the
    kernel's most, hanging over both ends of the 300 cells ("w256")."""
    cell, s, ok = _signals(16, 200, 300, seed=0)
    rng = np.random.default_rng(9)
    if case in ("max", "max_ties"):
        if case == "max_ties":
            cell = np.where(ok, cell % 12, cell).astype(np.int32)
            s = rng.choice(np.float32([0.25, 0.75, 1.0]), s.shape)
        s = np.where(ok, s - 0.5, -np.inf).astype(np.float32)
        return cell, s, dict(n_cells=300, combine="max")
    if case == "edges":
        cell = rng.choice(np.r_[0:35, 265:300], cell.shape).astype(np.int32)
        cell[:, :4] = [0, 299, -1, 300]       # and just past either end
    elif case == "invalid":
        bad = rng.choice(np.int32([-1, -40, 300, 307, 2 ** 30]), cell.shape)
        cell = np.where(rng.uniform(size=cell.shape) < 0.75, bad, cell)
    ok = (cell >= 0) & (cell < 300)
    s = np.where(ok, s, 0.0).astype(np.float32)
    w, mode = {"sum": (None, 0), "w1": (np.float32([0.75]), 0),
               "w256": D.build_denoiser(1, 256, 0.35)}.get(
        case, D.build_denoiser(1, 35, 0.35))
    return cell, s, dict(n_cells=300, combine="sum", weights=w, w_mode=mode)


def _torch_grad(fn, cell, s, g, kw):
    st = torch.from_numpy(s).requires_grad_(True)
    out = fn(torch.from_numpy(cell), st, **kw)
    out.backward(torch.from_numpy(g))
    return out.detach(), st.grad.numpy()


@pytest.mark.parametrize("case", ["taps", "sum", "max"])
def test_bin_gradient_matches_reference_vjp(case):
    """The K5 Function's backward against jax.vjp of the reference's
    custom_vjp (interpret): 2 ulp on the tap path (the FMA note above),
    exact otherwise."""
    cell, s, kw = _grad_case(case)
    g = np.random.default_rng(3).normal(size=(16, 300)).astype(np.float32)
    _, got = _torch_grad(bin_signals, cell, s, g, kw)
    jkw = dict(kw, interpret=True)
    if kw.get("weights") is not None:
        jkw["weights"] = tuple(map(float, kw["weights"]))
    _, vjp = jax.vjp(lambda x: bin_signals_pallas(jnp.asarray(cell), x, **jkw),
                     jnp.asarray(s))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.abs(ref).max() > 0 and (ref == 0).any()
    rtol = _TAP_RTOL if case == "taps" else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


@pytest.mark.parametrize("case", ["taps", "sum", "max"])
def test_bin_wrapper_gradient_equals_plain_version(case):
    """The wrapper's gradient is the plain version's autograd gradient (on
    the card the kernel's output has no autograd graph of its own; the
    Function supplies it). Sum and max agree exactly; on the tap path
    autograd sums the 35 tap adjoints in another f32 order, so the two
    agree within 1e-6 of the largest gradient."""
    cell, s, kw = _grad_case(case)
    g = np.random.default_rng(4).normal(size=(16, 300)).astype(np.float32)
    out, got = _torch_grad(bin_signals, cell, s, g, kw)
    out_p, want = _torch_grad(_bin_plain, cell, s, g, kw)
    assert torch.equal(out, out_p)
    atol = 1e-6 * np.abs(want).max() if case == "taps" else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _edge_case(case):
    """(cell, s, out, bin kwargs) for the per-signal backward: duplicate
    cells, out-of-range cells, and cells within a tap window of either
    edge (c < W, c > n_cells - W)."""
    n_cells, W = 300, 35
    cell, s, kw = _grad_case(case)
    rng = np.random.default_rng(6)
    edge = np.concatenate([np.arange(0, W), np.arange(n_cells - W, n_cells),
                           [-1, -7, n_cells, n_cells + 3]])
    cell[:, -60:] = rng.choice(edge, (cell.shape[0], 60)).astype(np.int32)
    cell[:, -70:-60] = cell[:, -60:-50]                       # duplicates
    ok = (cell >= 0) & (cell < n_cells)
    fill = -np.inf if kw["combine"] == "max" else 0.0
    s = np.where(ok, np.abs(s) + 0.25, fill).astype(np.float32)
    out = _bin_plain(torch.from_numpy(cell), torch.from_numpy(s), **kw)
    return torch.from_numpy(cell), torch.from_numpy(s), out, _bwd_kw(kw)


def _bwd_kw(kw):
    """The backward's keyword arguments for _grad_case's bin kwargs (the
    taps as the Function stores them: a tuple of floats)."""
    w = kw.get("weights")
    return dict(n_cells=kw["n_cells"], combine=kw["combine"],
                weights=None if w is None else tuple(map(float, w)),
                w_mode=kw.get("w_mode", 0))


# K5's backward at the edges of what it takes (see _grad_case)
_BWD_CASES = ["taps", "sum", "max", "edges", "invalid", "max_ties", "w1",
              "w256"]


@pytest.mark.parametrize("case", _BWD_CASES)
def test_bin_bwd_signals_bit_equal_to_bin_bwd(case):
    """The per-signal backward (the kernel's order: each signal's own cell,
    taps in k order) returns the bits of _bin_bwd's full correlation and
    gather, at the edges and out of range too."""
    cell, s, out, kw = _edge_case(case)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(cell.shape[0], 300)).astype(np.float32))
    got = _bin_bwd_signals(cell, s, out, g, **kw)
    want = _bin_bwd(cell, s, out, g, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ok = (cell >= 0) & (cell < 300)
    assert (got[~ok] == 0).all() and got[ok].abs().max() > 0
    edge = ok & ((cell < 35) | (cell > 300 - 35))
    assert edge.sum() > 100 and got[edge].abs().max() > 0


@pytest.mark.parametrize("case", _BWD_CASES)
def test_bin_bwd_signals_matches_reference_vjp(case):
    """The per-signal backward against jax.vjp of the reference's
    custom_vjp (interpret), within test_bin_gradient_matches_reference_vjp's
    tolerance: 2 ulp on the tap path, exact otherwise."""
    cell, s, kw = _grad_case(case)
    g = np.random.default_rng(3).normal(size=(16, 300)).astype(np.float32)
    out = _bin_plain(torch.from_numpy(cell), torch.from_numpy(s), **kw)
    bkw = _bwd_kw(kw)
    got = _bin_bwd_signals(torch.from_numpy(cell), torch.from_numpy(s), out,
                           torch.from_numpy(g), **bkw)
    jkw = dict(kw, interpret=True, weights=bkw["weights"])
    _, vjp = jax.vjp(lambda x: bin_signals_pallas(jnp.asarray(cell), x, **jkw),
                     jnp.asarray(s))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.abs(ref).max() > 0 and (ref == 0).any()
    rtol = _TAP_RTOL if case == "taps" else 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=0)


def test_bin_plain_writes_positive_zero_in_empty_windows():
    """Wherever an output's tap window [c - (W-1-mode), c + mode] holds
    only +-0 point values, the plain tap sum is +0.0 exactly (the bits the
    kernel writes there without running the taps) — with a negative tap
    (w * +0 = -0) and -0 strengths among the signals."""
    n_cells, W, mode = 200, 7, 2
    w = np.array([0.5, -0.25, 1.0, 0.75, -1.5, 0.125, 2.0], np.float32)
    cell = np.array([[50, 50, 90, 120, 160, 199, 0, n_cells],
                     [n_cells] * 7 + [30]], np.int32)
    s = np.array([[1.5, -0.5, -0.0, 2.0, -0.0, 0.75, 3.0, 9.0],
                  [9.0] * 7 + [-0.0]], np.float32)
    got = _bin_plain(torch.from_numpy(cell), torch.from_numpy(s),
                     n_cells=n_cells, combine="sum", weights=tuple(
                         map(float, w)), w_mode=mode).numpy()
    point = _bin_plain(torch.from_numpy(cell), torch.from_numpy(s),
                       n_cells=n_cells, combine="sum").numpy()
    nz = np.pad(point != 0, ((0, 0), (W - 1 - mode, mode)))
    has = np.stack([nz[:, c:c + W].any(axis=1) for c in range(n_cells)], 1)
    assert has.any() and (~has).any()
    assert (got[~has].view(np.int32) == 0).all()       # +0.0, not -0.0
    assert (got[has] != 0).any()
    # windows around the -0 strengths and the -0-only row are among them
    assert not has[0, 90] and not has[0, 160] and not has[1].any()
