"""The comparison that decides `correct`: the answers the window produced,
sampled from the seed, against the plain reference the configuration names
(portbench/reference/<name>.py) in the configurations' precision, float32
with TF32 off (set by the reference itself, whatever the program set),
number by number, each against its limit in portbench/limits/
<workload>.json.

Frame cells: for each kept frame, `columns` of its 400 azimuths drawn from
the seed; the reference renders those columns from the frame's own inputs
(pose, cone draws, Perlin offsets) and the raw soup. Numbers:
  px_off     share of the sampled pixels whose u8 differs by more than 1
  col_off    share of the sampled columns with such a pixel
  maxval_gap the worst column's |max_val - reference| / reference

Fit cells, gradient: the kept fit's start, its first three losses, the
gradient Adam got at step 0 and z before steps 0 and 3, against the
reference's Adam from the same start. Numbers (by the worst leaf, a leaf
being one tuned scalar; leaves whose reference gradient is under 1e-3 of
the median leaf's are left out):
  loss_gap   worst |loss - reference| / |reference| over steps 0-2
  grad_gap   worst ||g| - |g_ref|| / max(|g_ref|, median |g_ref|), step 0
  step_gap   the same of z's change over the first three steps
Fit cells, black box: `evals` of the kept fit's evaluations (its best and
others drawn from the seed), the reference's objective at the same
vectors:
  eval_gap   worst |value - reference| / |reference|
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench.generator import reference
from portbench.reference import frame as RF
from portbench.system import MAT_KEYS

LEAF_FLOOR = 1e-3


def load_limits(path: Path) -> dict:
    return json.loads(path.read_text())["limits"] if path.exists() else {}


# --------------------------------------------------------------- frames

def frame_rows(kept: list, n_angles: int, columns: int,
               rng: np.random.Generator, device):
    """(Rows, the program's u8 columns (R, n_cells), its max_val (R,),
    the sampled frame of each row)."""
    poses, col, th, ra, rb, u8, mv, which = [], [], [], [], [], [], [], []
    for i, k in enumerate(kept):
        cols = np.sort(rng.choice(n_angles, size=min(columns, n_angles),
                                  replace=False))
        c = torch.from_numpy(cols).to(device)
        poses.append(torch.from_numpy(k["pose"]).to(device).expand(
            len(cols), 7))
        col.append(c)
        th.append(torch.as_tensor(k["theta"]).to(device).expand(
            len(cols), -1))
        ra.append(torch.as_tensor(k["radial"]).to(device).expand(
            len(cols), -1))
        if k["rb"] is not None:
            rb.append(torch.as_tensor(k["rb"]).to(device)[c])
        u8.append(torch.from_numpy(k["u8"][:, cols].T.copy()))
        mv.append(torch.as_tensor(k["max_val"]).cpu()[torch.from_numpy(
            cols)])
        which += [i] * len(cols)
    rows = RF.Rows(torch.cat(poses), torch.cat(col), torch.cat(th),
                   torch.cat(ra), torch.cat(rb) if rb else None)
    return rows, torch.cat(u8), torch.cat(mv), np.array(which)


def reference_columns(conf: dict, soup, om, rows, device,
                      dtype=torch.float32, tf32: bool = False,
                      block: int = 64):
    """The reference's (u8 (R, n_cells), max_val (R,)) of the rows, in
    blocks of `block` rows, by the frame reference the configuration
    names."""
    ref = reference(conf)
    geo = ref.geometry(soup.verts, soup.obj, dtype, device, tf32=tf32)
    table = torch.tensor([[float(e[k]) for k in MAT_KEYS]
                          for e in conf["materials"]], dtype=dtype,
                         device=device)
    om = torch.as_tensor(om).long().to(device)
    radar = conf["radar"]
    bw = math.radians(conf["beam_width_deg"])
    us, ms = [], []
    R = rows.pose.shape[0]
    with torch.no_grad():
        for s in range(0, R, block):
            part = ref.Rows(*(None if x is None else x[s:s + block]
                              for x in rows))
            img, mv = ref.render_rows(geo, table, om, radar, part, bw)
            us.append(ref.u8(img, mv, radar).cpu())
            ms.append(mv.cpu())
    return torch.cat(us), torch.cat(ms)


def frame_numbers(u8, mv, ref_u8, ref_mv) -> dict:
    d = (u8.int() - ref_u8.int()).abs()
    mv, ref_mv = mv.double(), ref_mv.double()
    gap = (mv - ref_mv).abs() / torch.clamp_min(ref_mv.abs(), 1e-30)
    gap = torch.where((mv == 0) & (ref_mv == 0), 0.0, gap)
    return dict(px_off=float((d > 1).double().mean()),
                col_off=float((d > 1).any(1).double().mean()),
                maxval_gap=float(gap.max()))


def frame_failed(u8, mv, ref_u8, ref_mv, which, limits) -> int:
    """How many sampled frames break a limit on their own columns."""
    bad = 0
    for i in np.unique(which):
        m = torch.from_numpy(which == i)
        nums = frame_numbers(u8[m], mv[m], ref_u8[m], ref_mv[m])
        bad += any(nums[k] > limits.get(k, math.inf) for k in nums)
    return bad


# ------------------------------------------------------------------ fit

def _leaf_gap(p: np.ndarray, r: np.ndarray, counted: np.ndarray) -> float:
    """Worst ||p| - |r|| / max(|r|, median |r|) over the counted leaves."""
    p, r = np.abs(p), np.abs(r)
    med = float(np.median(r))
    g = np.abs(p - r) / np.maximum(np.maximum(r, med), 1e-300)
    return float(g[counted].max()) if counted.any() else 0.0


def adam_numbers(problem, targets, rec: dict, ref: Optional[dict] = None
                 ) -> dict:
    """The gradient fit's numbers of one kept fit (module doc); `ref` is
    the reference's follow() when already computed."""
    if ref is None:
        ref = problem.follow(rec["v0"], targets, 3, rec["lr"])
    p_loss = np.array(rec["history"][:3], np.float64)
    r_loss = np.array(ref["loss"], np.float64)
    g_r = ref["grad"][0].cpu().numpy()
    g_p = rec["steps"][0][1].double().cpu().numpy()
    dz_r = (ref["z"][3] - ref["z"][0]).cpu().numpy()
    dz_p = (rec["steps"][3][0] - rec["steps"][0][0]).double().cpu().numpy()
    counted = np.abs(g_r) >= LEAF_FLOOR * np.median(np.abs(g_r))
    return dict(
        loss_gap=float(np.max(np.abs(p_loss - r_loss) / np.abs(r_loss))),
        grad_gap=_leaf_gap(g_p, g_r, counted),
        step_gap=_leaf_gap(dz_p, dz_r, counted))


def bbox_pick(rec: dict, n: int, rng: np.random.Generator) -> list:
    """The best evaluation and n - 1 others drawn from the seed."""
    ev = rec["evals"]
    best = int(np.argmin([v for _, v in ev]))
    rest = [i for i in range(len(ev)) if i != best]
    pick = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [best] + sorted(int(i) for i in pick)


def bbox_numbers(problem, targets, rec: dict, picks: list,
                 values: Optional[list] = None) -> dict:
    """eval_gap of the picked evaluations; `values` replaces the program's
    values (a control)."""
    gaps = []
    for j, i in enumerate(picks):
        v, f = rec["evals"][i]
        if values is not None:
            f = values[j]
        with torch.no_grad():
            # the program got the vector as float32
            r = float(problem.loss_v(torch.as_tensor(
                np.asarray(v, np.float32), device=problem.device).to(
                    problem.dtype), targets))
        gaps.append(abs(f - r) / abs(r))
    return dict(eval_gap=float(max(gaps)))
