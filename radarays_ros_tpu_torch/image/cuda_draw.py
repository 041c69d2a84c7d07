"""Signal binning with fused denoise taps: the CUDA kernel K5 (forward and
backward) and its plain torch versions (counterpart of
radarays_ros_tpu/image/pallas_draw.py).

`bin_signals(cell, s, ...)` bins (A, N) (cell, strength) signals into an
(A, n_cells) image — sum, optionally followed by the W denoise taps
img[c] += w[k] * point[c - (k - mode)], or max clamped at >= 0. Invalid
signals must arrive with a cell outside [0, n_cells) (image/draw.py maps
them to n_cells). The sum runs in signal order and the taps in k order
from 0.0, each product and sum rounded separately: the f32 order of the
reference's kernel and shift-add (image/draw.py:145-149), so the kernel
and the plain version agree bit for bit. (The reference's kernel run in
interpret mode on XLA:CPU has some tap multiply-adds contracted into FMAs;
there the taps agree to 2 ulp, tests/test_torch_draw.py.)

`bin_signals` is a torch.autograd.Function, differentiable w.r.t. the
strengths like the reference's custom_vjp (pallas_draw.py:99-149). Its
backward, `bin_bwd`, is the reference's _bin_bwd: the adjoint correlation
of the taps, then a gather at each signal's cell (0 outside
[0, n_cells)); for max, every signal equal to its cell's output takes the
cotangent (ties take all). On CPU tensors it is the reference's XLA code
in torch (`_bin_bwd`); on CUDA tensors the kernel rr_bin_bwd computes the
correlation at the gathered cells only, term for term, which
`_bin_bwd_signals` does in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_MAX_TAPS = 256   # bin.cu's RR_MAX_TAPS: the taps ride in the launch's
                  # parameter block


def _bin_plain(cell, s, *, n_cells: int, combine: str, weights=None,
               w_mode: int = 0):
    """Plain K5: serial per-signal accumulation (one scatter per signal
    index, so no row sees two updates in one step and the f32 order is the
    signal order), then the taps as W shifted multiply-adds."""
    A, N = cell.shape
    ok = (cell >= 0) & (cell < n_cells)
    idx = torch.where(ok, cell, n_cells).long()
    if combine == "max":
        img = torch.full((A, n_cells + 1), -torch.inf, device=s.device)
        img.scatter_reduce_(1, idx, torch.where(ok, s, -torch.inf), "amax")
        return torch.clamp_min(img[:, :n_cells], 0.0)
    point = torch.zeros((A, n_cells + 1), device=s.device)
    sv = torch.where(ok, s, 0.0)
    for n in range(N):
        point.scatter_add_(1, idx[:, n:n + 1], sv[:, n:n + 1])
    point = point[:, :n_cells]
    if weights is None:
        return point
    W = len(weights)
    padded = torch.nn.functional.pad(point, (W - 1, W - 1))
    img = torch.zeros_like(point)
    for k in range(W):
        off = (W - 1) - (k - w_mode)
        img = img + float(weights[k]) * padded[:, off:off + n_cells]
    return img


def _bin_bwd(cell, s, out, g, *, n_cells: int, combine: str, weights,
             w_mode: int):
    """d loss / d s for the cotangent g (A, n_cells): the reference's
    _bin_bwd (pallas_draw.py:111-146), in its order of operations."""
    if weights is not None:
        # adjoint of img[c] += w[k] point[c - d]: d point[p] += w[k] g[p + d]
        gc = torch.zeros_like(g)
        for k, wk in enumerate(weights):
            d = k - w_mode
            if d == 0:
                sh = g
            elif d > 0:
                sh = torch.nn.functional.pad(g[:, d:], (0, d))
            else:
                sh = torch.nn.functional.pad(g[:, :n_cells + d], (-d, 0))
            gc = gc + wk * sh
        g = gc
    safe = torch.clamp(cell, 0, n_cells - 1).long()
    ok = (cell >= 0) & (cell < n_cells)
    g_at = torch.gather(g, 1, safe)
    if combine == "max":
        ok = ok & (s == torch.gather(out, 1, safe))
    return torch.where(ok, g_at, 0.0)


def _bin_bwd_signals(cell, s, out, g, *, n_cells: int, combine: str,
                     weights, w_mode: int):
    """Plain K5 backward as the kernel computes it: per signal, the taps'
    adjoint at its own cell only, ds = sum_k w[k] g[c + k - mode] (0
    outside [0, n_cells)) in k order from 0.0 — the terms and order of
    _bin_bwd's correlation at the gathered cell, so bit-equal to it."""
    if weights is None:
        return _bin_bwd(cell, s, out, g, n_cells=n_cells, combine=combine,
                        weights=None, w_mode=w_mode)
    ok = (cell >= 0) & (cell < n_cells)
    ds = torch.zeros_like(s)
    for k, wk in enumerate(weights):
        src = cell.long() + (k - w_mode)
        inside = (src >= 0) & (src < n_cells)
        p = torch.gather(g, 1, src.clamp(0, n_cells - 1))
        ds = ds + wk * torch.where(inside, p, 0.0)
    return torch.where(ok, ds, 0.0)


class _Bin(torch.autograd.Function):
    """K5: the kernel (CUDA tensors) or the plain version (CPU tensors),
    forward and backward; cells get no gradient."""

    @staticmethod
    def forward(ctx, cell, s, n_cells, combine, weights, w_mode):
        run = _bin_plain if s.device.type == "cpu" else _bin_launch
        out = run(cell, s, n_cells=n_cells, combine=combine,
                  weights=weights, w_mode=w_mode)
        ctx.meta = dict(n_cells=n_cells, combine=combine, weights=weights,
                        w_mode=w_mode)
        ctx.save_for_backward(cell, s, out)
        return out

    @staticmethod
    def backward(ctx, g):
        cell, s, out = ctx.saved_tensors
        return (None, bin_bwd(cell, s, out, g, **ctx.meta), None, None,
                None, None)


def bin_signals(cell, s, *, n_cells: int, combine: str = "sum", weights=None,
                w_mode: int = 0):
    """K5 wrapper, differentiable w.r.t. s: plain version on CPU tensors,
    the CUDA kernel rr_bin on CUDA tensors. cell (A, N) int32, s (A, N)
    float32; weights (static float32 taps, combine "sum" only) and w_mode
    fuse the denoise."""
    if combine not in ("sum", "max"):
        raise ValueError(f"unknown combine {combine!r}")
    if weights is not None and combine != "sum":
        raise ValueError("fused denoise taps require combine='sum'")
    w = None if weights is None else tuple(
        float(x) for x in np.asarray(weights, np.float32))
    return _Bin.apply(cell, s, n_cells, combine, w, int(w_mode))


@functools.lru_cache(maxsize=16)
def _host_taps(weights):
    """The taps as a C float array in host memory (None without taps):
    rr_bin and rr_bin_bwd pass them by value in the launch's parameters,
    so no call copies them to the device."""
    if weights is None:
        return None
    if len(weights) > _MAX_TAPS:
        raise ValueError(f"bin_signals: {len(weights)} taps, the kernels "
                         f"take at most {_MAX_TAPS}")
    return (ctypes.c_float * len(weights))(*weights)


def _taps_args(weights):
    taps = _host_taps(weights)
    return ((None, 0) if taps is None
            else (ctypes.addressof(taps), len(taps)))


def _bin_launch(cell, s, *, n_cells: int, combine: str, weights, w_mode: int):
    """Launch rr_bin on CUDA tensors (the forward of bin_signals)."""
    from radarays_ros_tpu_torch import cuda_build

    cuda_build.check_tensors("bin_signals", cell, s,
                             dtypes=(torch.int32, torch.float32))
    if cell.shape != s.shape or cell.dim() != 2:
        raise ValueError("bin_signals: cell and s must be the same (A, N)")
    A, N = cell.shape
    out = torch.empty((A, n_cells), dtype=torch.float32, device=s.device)
    lib = cuda_build.build().lib
    cuda_build.check(lib.rr_bin(
        cell.data_ptr(), s.data_ptr(), A, N, n_cells, *_taps_args(weights),
        w_mode, int(combine == "max"), out.data_ptr(),
        cuda_build.stream_ptr(s)), "rr_bin")
    bin_signals.launches += 1
    return out


bin_signals.launches = 0


def bin_bwd(cell, s, out, g, *, n_cells: int, combine: str, weights,
            w_mode: int):
    """K5 backward wrapper (the backward of bin_signals): d loss / d s for
    the cotangent g (A, n_cells) — _bin_bwd on CPU tensors, the CUDA kernel
    rr_bin_bwd on CUDA tensors."""
    if g.device.type == "cpu":
        return _bin_bwd(cell, s, out, g, n_cells=n_cells, combine=combine,
                        weights=weights, w_mode=w_mode)
    from radarays_ros_tpu_torch import cuda_build

    g = g.contiguous()
    cuda_build.check_tensors("bin_bwd", cell, s, out, g,
                             dtypes=(torch.int32,) + (torch.float32,) * 3)
    A, N = cell.shape
    if s.shape != (A, N) or out.shape != (A, n_cells) \
            or g.shape != (A, n_cells):
        raise ValueError(f"bin_bwd: cell {tuple(cell.shape)}, s "
                         f"{tuple(s.shape)}, out {tuple(out.shape)}, g "
                         f"{tuple(g.shape)} for {n_cells} cells")
    ds = torch.empty_like(s)
    lib = cuda_build.build().lib
    cuda_build.check(lib.rr_bin_bwd(
        cell.data_ptr(), s.data_ptr(), out.data_ptr(), g.data_ptr(), A, N,
        n_cells, *_taps_args(weights), w_mode, int(combine == "max"),
        ds.data_ptr(), cuda_build.stream_ptr(g)), "rr_bin_bwd")
    bin_bwd.launches += 1
    return ds


bin_bwd.launches = 0
