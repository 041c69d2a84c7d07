"""Traffic kind "frames": calls of `simulate_frames_jit` (batch > 1) or
`simulate_frame_jit` (batch 1) on consecutive poses of the configuration's
loop, each call's u8 images fetched to the host before the next call. Cone
draws fresh each call (`fresh_cone_draws`) or held fixed as `Radar` holds
them; Perlin offsets fresh each call. Poses are host tensors, as a
trajectory file gives them, and the same in every run, from the
trajectory's `phase_deg`; the random inputs are drawn on the card from
the seed. Set-up warms the shape with two calls (a capture and a replay).

`check` compares sampled columns of the kept frames with the reference the
configuration names; `readings` gives calibrate's readings.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import check as CK
from portbench import system as S
from portbench.generator import (CHECK, INPUTS, Profiled, Reservoir, Window,
                                 cone_draws, fence, stream, torch_seed)
from portbench.scene import loop_pose


class Cell:
    """Set-up and window of a "frames" traffic on one configuration."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = torch.device(device)
        self.reference_s = 0.0       # the reference does no set-up work
        self.sys = S.build(conf, device)
        cfg = self.sys.cfg
        self.N = traffic["batch"]
        self.params = S.port_params(
            S.material_table(conf["materials"], device),
            self.sys.object_materials, conf["beam_width_deg"])
        self.gen = torch.Generator(self.device).manual_seed(
            torch_seed(seed, INPUTS))
        tr = conf["trajectory"]
        # every run drives the same poses in the same order; the seed
        # draws the cone draws and the noise
        self.phi0 = math.radians(tr["phase_deg"])
        self.dphi = tr["step_m"] / tr["radius"]
        self.fixed = None
        if not traffic["fresh_cone_draws"]:
            # one set of cone draws held in every frame, as Radar holds its
            # own, and the same in every run: the rays' work does not move
            # with the run's seed
            self.fixed = cone_draws(torch.Generator(self.device).manual_seed(
                traffic["held_cone_seed"]), 1, cfg)
        self.noise = cfg.ambient_noise == 2
        if cfg.ambient_noise not in (0, 2):
            raise ValueError("frames traffic draws Perlin offsets only")

    def inputs(self, k: int):
        """Call k's (poses (N, 7) host, (theta, radial) (N, S), Perlin
        offsets (N, A) or None)."""
        tr = self.conf["trajectory"]
        phi = self.phi0 + self.dphi * (k * self.N + np.arange(self.N))
        poses = torch.from_numpy(loop_pose(phi, tr["radius"], tr["height"]))
        if self.fixed is None:
            draws = cone_draws(self.gen, self.N, self.sys.cfg)
        else:
            draws = tuple(d.expand(self.N, -1) for d in self.fixed)
        rb = (torch.randint(0, 1000, (self.N, self.sys.cfg.n_angles),
                            generator=self.gen, device=self.device)
              if self.noise else None)
        return poses, draws, rb

    def call(self, k: int):
        """(u8 images (N, n_cells, A) on the host, max_val on the card,
        seconds inside the entry call)."""
        from radarays_ros_tpu_torch.sim.pipeline import (simulate_frame_jit,
                                                         simulate_frames_jit)

        poses, draws, rb = self.inputs(k)
        t0 = time.perf_counter()
        if self.N == 1:
            res = simulate_frame_jit(
                self.sys.scene, self.params, self.sys.cfg, poses[0],
                cone_draws=(draws[0][0], draws[1][0]),
                random_begin=None if rb is None else rb[0])
            t1 = time.perf_counter()
            u8 = res.image_u8.cpu().numpy()[None]
            mv = res.max_val[None]
        else:
            res = simulate_frames_jit(
                self.sys.scene, self.params, self.sys.cfg, poses,
                cone_draws=draws, random_begin=rb)
            t1 = time.perf_counter()
            u8 = res.image_u8.cpu().numpy()
            mv = res.max_val
        t2 = time.perf_counter()
        return (poses, draws, rb), u8, mv, t1 - t0, t2 - t0

    def warm(self) -> None:
        for k in (-2, -1):
            self.call(k)
        fence(self.device)

    def window(self, seconds: float, trace_calls: int) -> Window:
        win = Window()
        res = Reservoir(self.traffic["check"]["frames"], stream(self.seed,
                                                                CHECK))
        prof = Profiled(trace_calls, self.device)
        win.start = time.perf_counter()
        k = 0
        while k == 0 or time.perf_counter() - win.start < seconds:
            with prof.span(k):
                inp, u8, mv, host, lat = self.call(k)
            win.host_s.append(host)
            win.latency_s.append(lat)
            win.calls += 1
            win.frames += self.N
            win.attempted += self.N
            prof.stop_after(k, win, win.frames, 0)
            poses, draws, rb = inp
            for f in range(self.N):
                slot = res.slot()
                if slot is not None:
                    res.items[slot] = dict(
                        pose=poses[f].numpy().copy(), theta=draws[0][f],
                        radial=draws[1][f], rb=None if rb is None else rb[f],
                        u8=u8[f].copy(), max_val=mv[f])
            k += 1
        win.end = time.perf_counter()
        prof.close(win, win.frames, 0)
        win.kept = res.kept()
        return win

    def free(self) -> None:
        """Drop the program's state (its graphs and scene) before the
        reference runs."""
        from radarays_ros_tpu_torch.sim.pipeline import frame_graphs

        frame_graphs.clear()
        self.sys = self.sys._replace(scene=None)
        self.params = None


def check(cell, win, conf, traffic, seed, device, limits):
    rng = stream(seed, CHECK + 100)
    rows, u8, mv, which = CK.frame_rows(
        win.kept, conf["radar"]["n_angles"], traffic["check"]["columns"],
        rng, device)
    ref_u8, ref_mv = CK.reference_columns(conf, cell.sys.soup,
                                          cell.sys.object_materials, rows,
                                          device)
    nums = CK.frame_numbers(u8, mv, ref_u8, ref_mv)
    failed = CK.frame_failed(u8, mv, ref_u8, ref_mv, which, limits)
    return nums, failed


def readings(cell, win, conf, traffic, seed, device) -> dict:
    """The program's numbers against the reference (float32, TF32 off),
    the TF32 control's, and the program's against float64."""
    rng = stream(seed, CHECK + 100)
    rows, u8, mv, _ = CK.frame_rows(win.kept, conf["radar"]["n_angles"],
                                    traffic["check"]["columns"], rng, device)
    soup, om = cell.sys.soup, cell.sys.object_materials
    t0 = time.perf_counter()
    ref = CK.reference_columns(conf, soup, om, rows, device)
    ref_s = time.perf_counter() - t0
    ctl = CK.reference_columns(conf, soup, om, rows, device, tf32=True)
    f64 = CK.reference_columns(conf, soup, om, rows, device,
                               dtype=torch.float64)
    return dict(program=CK.frame_numbers(u8, mv, *ref),
                control=CK.frame_numbers(*ctl, *ref),
                f64=CK.frame_numbers(u8, mv, *f64), reference_s=ref_s,
                rows=int(rows.pose.shape[0]))
