"""The plain reference of the material fit: the objective of the upstream
fit (scripts/radaray_opti.py:205, -PSNR of the simulated frames against the
targets, on the per-column normalized float image before its rounding),
its gradient by autograd through the reference frame, and Adam
(Kingma & Ba, beta 0.9/0.999, eps 1e-8, bias-corrected) on the
sigmoid-reparameterized vector of the tuned material scalars, as the
upstream fit bounds them (radaray_opti.py:37-113).

It takes the soup, the poses, the cone draws and the material numbers the
benchmark made, and nothing the program made; the targets are its own
frames at the true materials.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import frame as F

KEYS = ("velocity", "ambient", "diffuse", "specular")
P_CLIP = 1e-4


def to_z(v, lo, hi) -> np.ndarray:
    p = np.clip((np.asarray(v, np.float64) - lo) / (hi - lo), P_CLIP,
                1 - P_CLIP)
    return np.log(p / (1 - p))


def to_vec(z, lo, hi) -> np.ndarray:
    return lo + (hi - lo) / (1 + np.exp(-np.asarray(z, np.float64)))


class Problem(NamedTuple):
    conf: dict
    geo: F.Geometry
    om: torch.Tensor
    rows: F.Rows
    bounds: tuple          # (lo, hi) numpy (n,)
    start_vec: np.ndarray  # (n,) the configuration's start
    n_frames: int

    @staticmethod
    def make(conf, soup, om, poses, draws, device, dtype=torch.float32,
             tf32: bool = False) -> "Problem":
        radar = conf["radar"]
        A = radar["n_angles"]
        N = poses.shape[0]
        n_i = torch.arange(N, device=device).repeat_interleave(A)
        a_i = torch.arange(A, device=device).repeat(N)
        poses = torch.as_tensor(poses).to(device)
        theta, radial = (torch.as_tensor(d).to(device) for d in draws)
        rows = F.Rows(poses[n_i], a_i, theta[n_i], radial[n_i], None)
        b = conf["bounds"]
        slots = conf["tuned_slots"]
        lo = np.array([b[k][0] for _ in slots for k in KEYS], np.float64)
        hi = np.array([b[k][1] for _ in slots for k in KEYS], np.float64)
        start = np.array([conf["materials_start"][s][k] for s in slots
                          for k in KEYS], np.float64)
        geo = F.geometry(soup.verts, soup.obj, dtype, device, tf32=tf32)
        return Problem(conf, geo, torch.as_tensor(om).long().to(device),
                       rows, (lo, hi), start, N)

    @property
    def dtype(self):
        return self.geo.W.dtype

    @property
    def device(self):
        return self.geo.W.device

    def table(self, v) -> torch.Tensor:
        """The (M, 4) material table with the tuned slots set to v."""
        t = torch.tensor([[float(e[k]) for k in KEYS]
                          for e in self.conf["materials_start"]],
                         dtype=self.dtype, device=self.device)
        slots = self.conf["tuned_slots"]
        rows = [v[4 * slots.index(s):4 * slots.index(s) + 4]
                if s in slots else t[s] for s in range(t.shape[0])]
        return torch.stack(rows)

    def frames(self, table):
        """(image_float, max_val) of every column of every frame."""
        bw = math.radians(self.conf["beam_width_deg"])
        return F.render_rows(self.geo, table, self.om, self.conf["radar"],
                             self.rows, bw)

    def placed(self, cols: torch.Tensor) -> torch.Tensor:
        """(N*A, n_cells) columns -> (N, n_cells, A), azimuth a at image
        column (scroll_image + a) % A."""
        radar = self.conf["radar"]
        A = radar["n_angles"]
        x = cols.view(self.n_frames, A, -1)
        where = (radar.get("scroll_image", 0) + torch.arange(A)) % A
        out = torch.zeros_like(x)
        out[:, where.to(x.device)] = x
        return out.transpose(1, 2)

    def targets(self) -> torch.Tensor:
        """The frames at the true materials as uint8 (N, n_cells, A)."""
        t = torch.tensor([[float(e[k]) for k in KEYS]
                          for e in self.conf["materials_true"]],
                         dtype=self.dtype, device=self.device)
        with torch.no_grad():
            img, mv = self.frames(t)
        return self.placed(F.u8(img, mv, self.conf["radar"]))

    def loss_v(self, v: torch.Tensor, targets: torch.Tensor,
               frames=None) -> torch.Tensor:
        """-mean PSNR over the frames (all, or the listed ones) of the
        float u8-scale image at the bounded vector v."""
        img, mv = self.frames(self.table(v))
        radar = self.conf["radar"]
        sim = self.placed(torch.clamp(F.scaled(img, mv, radar), 0, 255))
        tgt = targets.to(self.dtype)
        idx = range(self.n_frames) if frames is None else frames
        ps = [10.0 * torch.log10(255.0 ** 2 / torch.clamp_min(
            torch.mean((sim[i] - tgt[i]) ** 2), 1e-12)) for i in idx]
        return -torch.stack(ps).mean()

    def loss_z(self, z: torch.Tensor, targets, frames=None) -> torch.Tensor:
        lo, hi = (torch.as_tensor(x, dtype=self.dtype, device=self.device)
                  for x in self.bounds)
        return self.loss_v(lo + (hi - lo) * torch.sigmoid(z), targets,
                           frames)

    def follow(self, v0, targets, steps: int, lr: float, frames=None,
               frozen: bool = False) -> dict:
        """Adam from the start v0 for `steps` steps: each step's loss, the
        gradients as Adam gets them, and z before each step and after the
        last. `frozen` keeps z unchanged (a fault)."""
        lo, hi = self.bounds
        z = torch.tensor(to_z(v0, lo, hi), dtype=self.dtype,
                         device=self.device)
        m, s = torch.zeros_like(z), torch.zeros_like(z)
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = dict(loss=[], grad=[], z=[z.clone()])
        for t in range(1, steps + 1):
            zz = z.detach().requires_grad_(True)
            with F.exact_matmul():    # the backward's products too
                loss = self.loss_z(zz, targets, frames)
                g, = torch.autograd.grad(loss, zz)
            out["loss"].append(float(loss.detach()))
            out["grad"].append(g.detach())
            m = b1 * m + (1 - b1) * g
            s = b2 * s + (1 - b2) * g * g
            if not frozen:
                z = z - lr * (m / (1 - b1 ** t)) / (
                    torch.sqrt(s / (1 - b2 ** t)) + eps)
            out["z"].append(z.clone())
        return out
