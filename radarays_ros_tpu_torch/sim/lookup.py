"""The frame's material lookup: the four columns of the material table
gathered at each wave's material in one differentiable gather, whose
backward is the hand-written kernel rr_table_grad (csrc/lookup.cu).

It stands for the reference's per-column gathers, `params.materials.
velocity[refr_mat]` and `_shade`'s `m.ambient[mat_id]`, `m.diffuse[...]`,
`m.specular[...]` (radarays_ros_tpu/sim/pipeline.py:69-77, 175); the
reference has no module of its own for them, and their transpose there is
XLA's scatter-add.

`material_lookup(materials, idx)` stacks the (M, 4) table [velocity,
ambient, diffuse, specular] and gathers its rows at idx: a gather is exact,
so every frame keeps its bits. Its backward, the (M, 4) table gradient, is
`table_grad`: the kernel on CUDA tensors, `_table_grad_plain` on CPU
tensors. Both sum in one fixed order (slices of 1,024 rows, a pairwise tree
in each, then the slices in order: see csrc/lookup.cu), so the kernel is
bit-equal to its plain version and to itself over launches. A table of
more than MAX_MATERIALS rows is refused with MaterialCapRefused when it
needs a gradient.
"""

from __future__ import annotations

import torch

MAX_MATERIALS = 256   # lookup.cu's RR_TABLE_MAX_M: a CTA's bins in shared
                      # memory
_SLICE = 1024         # rows a CTA sums: RR_TG_ROWS x 8 warps x 32 lanes
_ROWS, _WARPS, _LANES = 4, 8, 32


class MaterialCapRefused(ValueError):
    """A material table larger than the kernel's cap: raised before
    launch (and on the CPU too, so that a fit refused on the card is
    refused everywhere)."""


def _check_cap(n_materials: int) -> None:
    if n_materials > MAX_MATERIALS:
        raise MaterialCapRefused(
            f"material_lookup: {n_materials} materials; the table gradient "
            f"takes at most {MAX_MATERIALS}")


def _table_grad_plain(idx, g, n_materials: int):
    """Plain rr_table_grad: out[m, j] = sum of g[i, j] over idx[i] == m, in
    the kernel's order. Row q of slice b (q = e * 256 + w * 32 + l) is
    summed per material from its masked value (g where idx == m, else +0):
    the pairwise tree over e ((v0 + v2) + (v1 + v3)), then over the 32
    lanes, then over the 8 warps, each level halving; then the slices'
    partials in slice order from the first."""
    idx = idx.reshape(-1)
    g = g.reshape(-1, 4)
    n = idx.shape[0]
    nb = -(-n // _SLICE)
    if nb == 0:
        return torch.zeros((n_materials, 4), dtype=g.dtype, device=g.device)
    pad = nb * _SLICE - n
    idx = torch.cat([idx, idx.new_full((pad,), -1)]).view(
        nb, _ROWS, _WARPS, _LANES)
    g = torch.cat([g, g.new_zeros((pad, 4))]).view(nb, _ROWS, _WARPS,
                                                   _LANES, 4)
    parts = []
    for m in range(n_materials):
        v = torch.where((idx == m)[..., None], g, 0.0)
        x = (v[:, 0] + v[:, 2]) + (v[:, 1] + v[:, 3])     # (nb, 8, 32, 4)
        h = _LANES // 2
        while h:
            x = x[:, :, :h] + x[:, :, h:2 * h]
            h //= 2
        x = x[:, :, 0]                                     # (nb, 8, 4)
        h = _WARPS // 2
        while h:
            x = x[:, :h] + x[:, h:2 * h]
            h //= 2
        parts.append(x[:, 0])
    part = torch.stack(parts, 1)                           # (nb, M, 4)
    acc = part[0]
    for b in range(1, nb):
        acc = acc + part[b]
    return acc


def table_grad(idx, g, n_materials: int):
    """The (n_materials, 4) table gradient of the rows gathered at idx for
    their cotangents g (idx.shape + (4,)): _table_grad_plain on CPU
    tensors, the CUDA kernel rr_table_grad on CUDA tensors."""
    _check_cap(n_materials)
    if g.device.type == "cpu":
        return _table_grad_plain(idx, g, n_materials)
    from radarays_ros_tpu_torch import cuda_build

    idx = idx.reshape(-1).contiguous()
    g = g.reshape(-1, 4).contiguous()
    if g.data_ptr() % 16:          # the kernel reads a row as one float4
        g = g.clone()
    cuda_build.check_tensors("table_grad", idx, g,
                             dtypes=(torch.int64, torch.float32))
    n = idx.shape[0]
    if g.shape[0] != n:
        raise ValueError(f"table_grad: {n} indices, cotangent "
                         f"{tuple(g.shape)}")
    part = torch.empty((-(-n // _SLICE), n_materials, 4),
                       dtype=torch.float32, device=g.device)
    out = torch.empty((n_materials, 4), dtype=torch.float32,
                      device=g.device)
    cuda_build.check(cuda_build.build().lib.rr_table_grad(
        idx.data_ptr(), g.data_ptr(), n, n_materials, part.data_ptr(),
        out.data_ptr(), cuda_build.stream_ptr(g)), "rr_table_grad")
    table_grad.launches += 1
    return out


table_grad.launches = 0


class _Lookup(torch.autograd.Function):
    """Rows of the (M, 4) table at idx; idx gets no gradient."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_materials = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return table_grad(idx.long(), g, ctx.n_materials), None


def material_lookup(materials, idx):
    """(velocity, ambient, diffuse, specular) of each material id in idx
    (int64, any shape) as one (*idx.shape, 4) gather of the stacked table,
    differentiable w.r.t. the table."""
    table = torch.stack(tuple(materials), dim=-1)
    if table.requires_grad:
        _check_cap(table.shape[0])
    return _Lookup.apply(table, idx)
