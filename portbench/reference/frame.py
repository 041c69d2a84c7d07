"""The plain reference frame: rotating-radar columns in plain PyTorch.

It follows the upstream engine's order of operations (uos/radarays_ros
RadarCPU.cpp:220-542) as the repository's scalar NumPy oracle
(tests/numpy_oracle.py) transcribes it, vectorized over waves so that it
runs on the card in blocks, in any float dtype:

    per column: transmit cone -> [nearest hit -> move -> material flip ->
    Snell/Fresnel split (reflection; refraction unless opaque) -> path
    return -> energy pruning] x n_reflections -> range binning with the
    denoise splat -> energy scale -> ambient noise -> per-column
    normalization -> uint8.

Every column of a frame is independent of the others, so the reference
computes any set of (pose, column) rows, and a sampled set of a frame's
columns is checked exactly as the whole frame would be.

The nearest hit is a Moller-Trumbore test of a ray against every triangle
of the raw soup that could hold its nearest hit, written as one matrix
product a block (Plucker form: det, u*det, v*det and t*det are each the
dot product of a ray's features [d, o x d, o, 1] with a triangle's), then
the sign-aware inside test and the nearest t >= 0 (lowest soup index on
ties). The soup is cut into blocks of nearby triangles (Morton order of
the centroids) with padded bounding boxes; a block whose box the ray
misses, or meets only beyond its best hit so far, is skipped, which
changes no answer. The matrix products run in full float32 (or float64),
TF32 off, whatever the process set (`exact_matmul`). With `tf32=True`
the inputs of every matrix product are rounded to TF32's 10 mantissa bits
(round to nearest even), as the card's TF32 matmuls round them: the
control of the comparison.

Supported: blinn_phong shading, triangular (and its alias gaussian)
denoising, ambient noise off or Perlin, no multipath returns; anything
else raises.

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from statistics import NormalDist
from typing import NamedTuple, Optional

import torch

from portbench.reference.perlin import perlin2

DET_EPS = 1e-12
T_MIN, T_MAX = 0.0, 1000.0
EPS_ANGLE = 1e-4
BLOCK = 4096        # triangles a block of the trace
AABB_PAD = 1e-3     # m, around each block's bounds


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def exact_matmul():
    """float32 matrix products in full float32 inside, TF32 off, whatever
    the process (the program under test) set; the flags are put back."""
    m, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, cd.allow_tf32)
    m.allow_tf32 = cd.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, cd.allow_tf32 = saved


def mm(a, b, tf32: bool):
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    with exact_matmul():
        return a @ b


# ------------------------------------------------------------------ trace

class Geometry(NamedTuple):
    W: torch.Tensor        # (10, 4, T) triangle features, in block order
    index: torch.Tensor    # (T,) int64 the soup index of each, in that order
    lo: torch.Tensor       # (B, 3) padded bounds of each block of `block`
    hi: torch.Tensor       # (B, 3) triangles
    n_unit: torch.Tensor   # (T, 3) unit geometric normals, soup order
    obj: torch.Tensor      # (T,) int64 object ids, soup order
    block: int
    tf32: bool


def _spread3(x):
    """10-bit integers -> their bits at every third place (Morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def geometry(verts, obj_ids, dtype, device, tf32: bool = False,
             block: int = BLOCK) -> Geometry:
    v = torch.as_tensor(verts, device=device).to(dtype)
    # blocks of nearby triangles: the soup sorted by the Morton code of
    # its centroids on a 1024-cell grid an axis
    c = v.mean(1)
    c0, c1 = c.amin(0), c.amax(0)
    q = ((c - c0) / torch.clamp_min(c1 - c0, 1e-30) * 1023).long()
    q = _spread3(q.clamp(0, 1023))
    index = torch.argsort(q[:, 0] | (q[:, 1] << 1) | (q[:, 2] << 2),
                          stable=True)
    vs = v[index]
    T = vs.shape[0]
    nb = -(-T // block)
    ends = torch.cat([vs, vs[-1:].expand(nb * block - T, 3, 3)])
    ends = ends.view(nb, block * 3, 3)
    lo, hi = ends.amin(1) - AABB_PAD, ends.amax(1) + AABB_PAD
    v0, e1, e2 = vs[:, 0], vs[:, 1] - vs[:, 0], vs[:, 2] - vs[:, 0]
    n = torch.linalg.cross(e1, e2)
    z3 = torch.zeros_like(v0)
    z1 = torch.zeros_like(v0[:, :1])
    vn = torch.sum(v0 * n, -1, keepdim=True)
    # rows: det, u*det, v*det, t*det; columns: [d, o x d, o, 1]
    rows = [torch.cat([-n, z3, z3, z1], 1),
            torch.cat([-torch.linalg.cross(e2, v0), e2, z3, z1], 1),
            torch.cat([-torch.linalg.cross(v0, e1), -e1, z3, z1], 1),
            torch.cat([z3, z3, n, -vn], 1)]
    W = torch.stack(rows, 0).permute(2, 0, 1).contiguous()   # (10, 4, T)
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n_unit = n / torch.clamp_min(torch.linalg.norm(n, dim=-1,
                                                   keepdim=True), 1e-30)
    return Geometry(W, index, lo, hi, n_unit,
                    torch.as_tensor(obj_ids, device=device).long(), block,
                    tf32)


def _boxes(geo: Geometry, o, d):
    """(entry t (R, B), whether the ray's [T_MIN, T_MAX] meets each
    block's box): the slab test, an axis that gives no number (a zero
    direction on the box's plane) counted as met."""
    inv = 1.0 / d
    t1 = (geo.lo[None] - o[:, None]) * inv[:, None]
    t2 = (geo.hi[None] - o[:, None]) * inv[:, None]
    near = torch.fmin(t1, t2).nan_to_num(nan=-math.inf).amax(-1)
    far = torch.fmax(t1, t2).nan_to_num(nan=math.inf).amin(-1)
    return near, (near <= far) & (far >= T_MIN) & (near <= T_MAX)


def trace(geo: Geometry, o, d, max_pairs: int = 1 << 27,
          rays: int = 1 << 15):
    """Nearest hits of rays (R, 3): (hit, t, unit normal facing the ray,
    object id); misses have t = inf, normal 0, object -1.

    Every triangle of a block whose padded box the ray meets before its
    best hit so far is tested, nearest blocks first; a block the ray
    misses, or meets only beyond that hit, holds no nearer hit. Equal t
    goes to the lowest soup index, as a test of the whole soup in its
    order gives it."""
    R, T = o.shape[0], geo.W.shape[2]
    dev, dt = o.device, o.dtype
    feats = torch.cat([d, torch.linalg.cross(o, d), o,
                       torch.ones_like(o[:, :1])], 1)
    best_t = torch.full((R,), math.inf, dtype=dt, device=dev)
    best_k = torch.full((R,), T, dtype=torch.int64, device=dev)
    for r0 in range(0, R, rays):
        r1 = min(R, r0 + rays)
        near, meets = _boxes(geo, o[r0:r1], d[r0:r1])
        n_meet = meets.sum(0)
        mean_near = torch.where(meets, near.clamp_min(0), 0).sum(0) \
            / n_meet.clamp_min(1)
        order = torch.argsort(mean_near)
        for b in order[n_meet[order] > 0].tolist():
            sel = meets[:, b] & (near[:, b] <= best_t[r0:r1])
            ids = sel.nonzero().squeeze(1) + r0
            if not ids.numel():
                continue
            t0 = b * geo.block
            Wb = geo.W[:, :, t0:t0 + geo.block].reshape(10, -1)
            kb = geo.index[t0:t0 + geo.block]
            n_t = kb.shape[0]
            step = max(1, max_pairs // n_t)
            for s in range(0, ids.numel(), step):
                ii = ids[s:s + step]
                out = mm(feats[ii], Wb, geo.tf32).view(-1, 4, n_t)
                det, ud, vd, td = out.unbind(1)
                inv = 1.0 / det
                u, v, t = ud * inv, vd * inv, td * inv
                ok = (det.abs() > DET_EPS) & (u >= 0) & (v >= 0) \
                    & (u + v <= 1) & (t >= T_MIN) & (t <= T_MAX)
                t = torch.where(ok, t, math.inf)
                bt = t.amin(1)
                bk = torch.where(ok & (t == bt[:, None]), kb[None],
                                 T).amin(1)
                cur_t, cur_k = best_t[ii], best_k[ii]
                better = (bt < cur_t) | ((bt == cur_t) & (bk < cur_k))
                best_t[ii] = torch.where(better, bt, cur_t)
                best_k[ii] = torch.where(better, bk, cur_k)
    hit = torch.isfinite(best_t)
    k = best_k.clamp_max(T - 1)
    n = geo.n_unit[k]
    n = torch.where(torch.sum(n * d, -1, keepdim=True) > 0, -n, n)
    return (hit, best_t, torch.where(hit[:, None], n, 0.0),
            torch.where(hit, geo.obj[k], -1))


# ---------------------------------------------------------- wave physics

def _acos(x):
    c = torch.clamp(x, -1.0, 1.0)
    # no gradient where the derivative is infinite (0 * inf would be NaN)
    return torch.arccos(torch.where(c.abs() < 1.0, c, c.detach()))


def _sqrt(x):
    c = torch.clamp_min(x, 0.0)
    return torch.sqrt(torch.where(c > 0.0, c, c.detach()))


def fresnel(normal, d, energy, pol, v1, v2):
    """Snell/Fresnel split (radar_algorithms.h:55-139 as the scalar oracle
    writes it): (reflection dir, refraction dir or 0, reflected energy,
    transmitted energy, incidence angle)."""
    n1, n2 = v2, v1
    ndd = torch.sum(normal * d, -1)
    inc = _acos(-ndd)
    refl = d - 2.0 * ndd[..., None] * normal
    one = torch.ones_like(n1)
    n21 = n2 / torch.where(n1 > 0, n1, one)
    limit = torch.where(n21.abs() <= 1, torch.arcsin(torch.clamp(n21, -1, 1)),
                        torch.full_like(n21, 100.0))
    branch = (n1 > 0) & (inc <= limit)
    transmits = branch & (n2 > 0)
    n_o = torch.where((ndd > 0)[..., None], -normal, normal)
    n12 = n1 / torch.where(n2 > 0, n2, one)
    c = torch.cos(inc)
    root = _sqrt(1.0 - n12 * n12 * (1.0 - c * c))
    cand = d * n12[..., None] + n_o * (n12 * c - root)[..., None]
    refr = torch.where(transmits[..., None], cand, torch.zeros_like(cand))
    r_ang = torch.where(transmits, _acos(torch.sum(refr * -n_o, -1)),
                        torch.full_like(inc, math.pi / 2))
    s = inc + r_ang
    sin_s, tan_s = torch.sin(s), torch.tan(s)
    ok_s, ok_t = sin_s.abs() > 1e-12, tan_s.abs() > 1e-12
    rs = torch.where(ok_s, -torch.sin(inc - r_ang)
                     / torch.where(ok_s, sin_s, 1.0), 1.0)
    rp = torch.where(ok_t, torch.tan(inc - r_ang)
                     / torch.where(ok_t, tan_s, 1.0), 1.0)
    nsum = n1 + n2
    rn = torch.where(nsum.abs() > 1e-12,
                     (n1 - n2) / torch.where(nsum.abs() > 1e-12, nsum, 1.0),
                     1.0)
    rs = torch.where(s < EPS_ANGLE, rn,
                     torch.where(s > math.pi - EPS_ANGLE, 1.0, rs))
    rp = torch.where(s < EPS_ANGLE, rn,
                     torch.where(s > math.pi - EPS_ANGLE, 1.0, rp))
    reff = torch.clamp(pol * rs * rs + (1.0 - pol) * rp * rp, 0.0, 1.0)
    return refl, refr, reff * energy, (1.0 - reff) * energy, inc


def shade(angle, energy, ambient, diffuse, specular):
    """Back-reflection (RadarCPU.cpp:310-316, radar_algorithms.h:168-187):
    (ambient + diffuse * max(cos, 0) ** specular) * energy."""
    c = torch.clamp_min(torch.cos(angle), 0.0)
    return (ambient + diffuse * torch.pow(c, specular)) * energy


# ------------------------------------------------------------- the frame

def denoise_taps(radar: dict, dtype, device):
    """(weights with the mode tap 1, mode index) of the triangular kernel
    (radar_algorithms.h:283-308 and RadarCPU.cpp:57, 83-91); None when
    denoising is off."""
    kind = radar.get("signal_denoising", 1)
    if kind == 0:
        return None, 0
    if kind not in (1, 2):
        raise NotImplementedError(f"signal_denoising {kind}")
    key = "triangular" if kind == 1 else "gaussian"
    width = int(radar[f"signal_denoising_{key}_width"])
    mode = int(radar[f"signal_denoising_{key}_mode"] * width)
    i = torch.arange(width, dtype=dtype, device=device)
    up = i / mode if mode > 0 else torch.ones_like(i)
    down = 1.0 - (i - mode) / (width - mode)
    return torch.where(i <= mode, up, down), mode


def cone_local(theta, radial, width, radar: dict):
    """(..., 3) beam-frame directions around +x from the draws (theta,
    radial) (radar_algorithms.cpp:248-294: R = Rz(beta) Ry(alpha))."""
    dist = radar.get("beam_sample_dist", 2)
    R = width / 2.0
    if dist == 0:
        r = radial * R
    elif dist == 1:
        r = torch.sqrt(radial) * R
    else:
        z = NormalDist().inv_cdf(
            (1.0 + radar.get("beam_sample_dist_normal_p_in_cone", 0.8)) / 2)
        r = (radial / z) * R if dist == 2 else torch.sqrt(radial.abs() / z) * R
    a, b = r * torch.cos(theta), r * torch.sin(theta)
    return torch.stack([torch.cos(b) * torch.cos(a),
                        torch.sin(b) * torch.cos(a), -torch.sin(a)], -1)


def quat_matrix(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


class Rows(NamedTuple):
    """The inputs of R (pose, column) rows: pose (R, 7), the column's
    azimuth index col (R,), its frame's cone draws theta, radial (R, S),
    and its Perlin row offset random_begin (R,) (None without noise)."""
    pose: torch.Tensor
    col: torch.Tensor
    theta: torch.Tensor
    radial: torch.Tensor
    random_begin: Optional[torch.Tensor]


def _check(radar: dict):
    if radar.get("record_multi_path", False):
        raise NotImplementedError("record_multi_path")
    if radar.get("reflection_model", "blinn_phong") != "blinn_phong":
        raise NotImplementedError(radar["reflection_model"])
    if radar.get("ambient_noise", 2) not in (0, 2):
        raise NotImplementedError(f"ambient_noise {radar['ambient_noise']}")


def signals(geo: Geometry, mats, om, radar: dict, rows: Rows, beam_width):
    """Every path return of the rows: (time, strength, valid), (R, n)."""
    _check(radar)
    dt, dev = mats.dtype, mats.device
    A = radar["n_angles"]
    air = radar.get("material_id_air", 0)
    thresh = radar.get("wave_energy_threshold", 0.001)
    skip = radar.get("skip_dist", 0.001)
    opaque = radar.get("opaque_materials", False)
    multi = radar.get("record_multi_reflection", True)
    pose = rows.pose.to(dt)
    local = cone_local(rows.theta.to(dt), rows.radial.to(dt),
                       torch.as_tensor(beam_width, dtype=dt, device=dev),
                       radar)                                    # (R, S, 3)
    az = -(2.0 * math.pi) * rows.col.to(dt) / A
    c, s = torch.cos(az), torch.sin(az)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rz = torch.stack([torch.stack([c, -s, zero], -1),
                      torch.stack([s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    R_am = mm(quat_matrix(pose[:, 3:7]), rz, geo.tf32)
    d = mm(local, R_am.transpose(1, 2), geo.tf32)                # (R, S, 3)
    sensor = pose[:, :3] + torch.tensor(
        [0.0, 0.0, radar.get("z_offset", 0.0)], dtype=dt, device=dev)
    o = sensor[:, None, :].expand_as(d)
    shape = d.shape[:2]
    energy = torch.ones(shape, dtype=dt, device=dev)
    pol = torch.full(shape, 0.5, dtype=dt, device=dev)
    vel = torch.full(shape, 0.3, dtype=dt, device=dev)
    time = torch.zeros(shape, dtype=dt, device=dev)
    mat = torch.full(shape, air, dtype=torch.int64, device=dev)
    valid = torch.ones(shape, dtype=torch.bool, device=dev)
    out = []
    for p in range(radar["n_reflections"]):
        hit = torch.zeros_like(valid)
        t = torch.zeros_like(time)
        normal = torch.zeros_like(d)
        obj = torch.zeros_like(mat)
        idx = valid.nonzero(as_tuple=True)
        if idx[0].numel():
            h, tt, nn, oo = trace(geo, o[idx].detach(), d[idx].detach())
            hit[idx], t[idx], normal[idx] = h, tt, nn
            obj[idx] = torch.clamp_min(oo, 0)
        alive = valid & hit
        t = torch.where(alive, t, 0.0)
        inc_o = o + d * t[..., None]
        inc_time = time + t / vel
        in_air = mat == air
        hit_mat = om[torch.clamp(obj, 0, om.shape[0] - 1)]
        refr_mat = torch.where(in_air, hit_mat, air)
        m = mats[refr_mat]                                        # (.., 4)
        v2 = torch.where(refr_mat == mat, vel, m[..., 0])
        refl, refr, e_refl, e_refr, inc = fresnel(normal, d, energy, pol,
                                                  vel, v2)
        refl_valid = alive & (e_refl > thresh)
        strength = shade(inc, e_refl, m[..., 1], m[..., 2], m[..., 3])
        out.append((2.0 * inc_time, strength,
                    refl_valid & in_air & (p == 0 or multi)))
        n_o = inc_o + refl * skip
        n_time = inc_time + skip / vel
        if opaque:
            o, d, energy, time, valid = n_o, refl, e_refl, n_time, refl_valid
            continue
        rv = alive & (e_refr > thresh) & (torch.sum(refr * refr, -1) > 0.25)
        r_vel = torch.where(rv, v2, vel)
        o = torch.cat([n_o, inc_o + refr * skip], 1)
        d = torch.cat([refl, refr], 1)
        energy = torch.cat([e_refl, e_refr], 1)
        time = torch.cat([n_time, inc_time + skip / r_vel], 1)
        vel = torch.cat([vel, r_vel], 1)
        mat = torch.cat([mat, torch.where(rv, refr_mat, mat)], 1)
        pol = torch.cat([pol, pol], 1)
        valid = torch.cat([refl_valid, rv], 1)
    return tuple(torch.cat([x[i] for x in out], 1) for i in range(3))


def bin_rows(times, strengths, valid, radar: dict):
    """(R, n_cells) image and (R,) column max, before the energy scale
    (RadarCPU.cpp:402-450): each signal splats its taps around its range
    cell, a signal whose centre cell is out of range is dropped whole, and
    range cell 0 is never written."""
    n_cells, res = radar["n_cells"], radar["resolution"]
    dt, dev = strengths.dtype, strengths.device
    R = times.shape[0]
    cell = torch.floor((0.3 * times.detach() / 2.0) / res)
    ok = valid & (cell >= 0) & (cell < n_cells)
    w, mode = denoise_taps(radar, dt, dev)
    if w is None:
        raise NotImplementedError("signal_denoising 0")
    r_i, s_i = ok.nonzero(as_tuple=True)
    c = cell[r_i, s_i].long()
    g = c[:, None] + torch.arange(w.shape[0], device=dev)[None] - mode
    keep = (g >= 1) & (g < n_cells)
    src = (strengths[r_i, s_i][:, None] * w[None])[keep]
    flat = (r_i[:, None] * n_cells + g)[keep]
    img = torch.zeros(R * n_cells, dtype=dt, device=dev).index_add(
        0, flat, src).view(R, n_cells)
    return img, img.amax(-1)


def ambient_noise(img, max_val, rows: Rows, radar: dict):
    """img (already scaled by energy_max) plus |noise| (RadarCPU.cpp
    :459-528) with the two-octave Perlin field at x = random_begin +
    i * scale, y = column * scale."""
    if radar.get("ambient_noise", 2) == 0:
        return img
    n_cells, res = radar["n_cells"], radar["resolution"]
    dt, dev = img.dtype, img.device
    i = torch.arange(n_cells, dtype=dt, device=dev)[None]
    col = ((radar.get("scroll_image", 0) + rows.col) % radar["n_angles"]
           ).to(dt)[:, None]
    x0 = rows.random_begin.to(dt)[:, None]
    lo = radar.get("ambient_noise_perlin_scale_low", 0.05)
    hi = radar.get("ambient_noise_perlin_scale_high", 0.2)
    pl = radar.get("ambient_noise_perlin_p_low", 0.9)
    p = pl * perlin2(x0 + i * lo, col * lo) \
        + (1.0 - pl) * perlin2(x0 + i * hi, col * hi)
    amp = max_val[:, None]
    sf = 1.0 - img / torch.where(amp > 0, amp, 1.0)
    s4 = sf ** 4
    noise_amp = s4 * (amp * radar["ambient_noise_at_signal_0"]) \
        + (1.0 - s4) * (amp * radar["ambient_noise_at_signal_1"])
    x = (i + 0.5) * res
    e_max = amp * radar["ambient_noise_energy_max"]
    e_min = amp * radar["ambient_noise_energy_min"]
    y = noise_amp * p + (e_max - e_min) * torch.exp(
        -radar.get("ambient_noise_energy_loss", 0.05) * x) + e_min
    return img + torch.abs(y)


def render_rows(geo: Geometry, mats, om, radar: dict, rows: Rows,
                beam_width):
    """(image_float (R, n_cells) after noise, max_val (R,))."""
    t, s, v = signals(geo, mats, om, radar, rows, beam_width)
    img, max_val = bin_rows(t, s, v, radar)
    img = img * radar["energy_max"]
    return ambient_noise(img, max_val, rows, radar), max_val


def u8(img, max_val, radar: dict):
    """Per-column normalization to uint8 (RadarCPU.cpp:533-542)."""
    return torch.clamp(torch.round(scaled(img, max_val, radar)), 0, 255).to(
        torch.uint8)


def scaled(img, max_val, radar: dict):
    pos = max_val > 0
    scale = torch.where(pos, radar["signal_max"]
                        / torch.where(pos, max_val, 1.0), 0.0)
    return img * scale[:, None]
