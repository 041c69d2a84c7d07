"""Traffic kind "fit": back-to-back material fits against targets made at
set-up by the reference the configuration names, each fit from its own
start: `optimize_gradient` (method "gradient") or
`optimize_black_box` over the compiled objective (method "black_box"), as
the CLI's `optimize` runs them. Each fit captures its own graph, as a
user's fit does. The frames' cone draws are held (`held_cone_seed`); the
starts come from the run's seed, or from a `pool` that every run shares
(`Cell.fits`). Set-up warms the shapes with one whole fit.

`check` follows a kept fit with the reference (Adam's first three steps,
or the black box's picked evaluations); `readings` gives calibrate's
readings, with the TF32 control and the faults read in the reference put
in the program's place.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import check as CK
from portbench import system as S
from portbench.generator import (CHECK, STARTS, WARM, Profiled, Reservoir,
                                 Window, cone_draws, fence, reference,
                                 stream)
from portbench.scene import loop_pose


class Cell:
    """Set-up and window of a "fit" traffic on one configuration."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from radarays_ros_tpu_torch.opti.optimize import (ParamVector,
                                                          default_objective)

        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = torch.device(device)
        self.sys = S.build(conf, device)
        cfg = self.sys.cfg
        fr = conf["frames"]
        # the same frames in every run; the seed draws the fits' starts
        phi = math.radians(fr["phase_deg"]) \
            + 2 * math.pi * np.arange(fr["n"]) / fr["n"]
        self.poses = torch.from_numpy(loop_pose(phi, fr["radius"],
                                                fr["height"]))
        # the frames' cone draws, held in every fit and run as live1 holds
        # its own: which rays run far does not move with the run's seed
        self.draws = cone_draws(torch.Generator(self.device).manual_seed(
            traffic["held_cone_seed"]), fr["n"], cfg)
        # the targets, the reference's frames at the true materials: the
        # reference's seconds are not set-up's
        t0 = time.perf_counter()
        self.problem = reference(conf).Problem.make(
            conf, self.sys.soup, self.sys.object_materials, self.poses,
            self.draws, self.device)
        self.targets_u8 = self.problem.targets()     # (N, n_cells, A)
        fence(self.device)
        self.reference_s = time.perf_counter() - t0
        if self.device.type == "cuda":
            # the reference's blocks are not the program's memory peak
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        b = conf["bounds"]
        self.pv = ParamVector(
            material_slots=tuple(conf["tuned_slots"]),
            tune_n_reflections=False, tune_beam_width=False,
            velocity_bounds=tuple(b["velocity"]),
            ambient_bounds=tuple(b["ambient"]),
            diffuse_bounds=tuple(b["diffuse"]),
            specular_bounds=tuple(b["specular"]))
        self.loss_of_params = default_objective(
            self.sys.scene, cfg, self.poses.to(self.device),
            self.targets_u8.to(self.device),
            cone_draws=self.draws)
        self.recording = None
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        self._hook = register_optimizer_step_pre_hook(self._pre_step)

    def _pre_step(self, opt, args, kwargs):
        """Keep z and its gradient as the optimizer gets them, at steps
        0-3 of a kept fit."""
        rec = self.recording
        if rec is not None and len(rec) < 4:
            p = opt.param_groups[0]["params"][0]
            rec.append((p.detach().clone(), p.grad.detach().clone()))

    def start(self, rng: np.random.Generator) -> np.ndarray:
        """A fit's start: the configuration's start, moved by the traffic's
        jitter in the sigmoid's coordinate, rounded to float32."""
        R = reference(self.conf)
        lo, hi = self.problem.bounds
        z = R.to_z(self.problem.start_vec, lo, hi)
        z = z + self.traffic["start_jitter"] * rng.standard_normal(z.shape)
        return R.to_vec(z, lo, hi).astype(np.float32)

    def params_at(self, v: np.ndarray):
        t = S.material_table(self.conf["materials_start"], self.device)
        for i, s in enumerate(self.conf["tuned_slots"]):
            t[s] = torch.from_numpy(v[4 * i:4 * i + 4]).to(self.device)
        return S.port_params(t, self.sys.object_materials,
                             self.conf["beam_width_deg"])

    def fit(self, v: np.ndarray, fit_seed: int, keep: bool):
        """One fit from v: (evaluations, record for the check or None)."""
        from radarays_ros_tpu_torch.opti.optimize import (compiled,
                                                          optimize_black_box,
                                                          optimize_gradient)

        p0 = self.params_at(v)
        tr = self.traffic
        if tr["method"] == "gradient":
            self.recording = [] if keep else None
            try:
                out = optimize_gradient(self.loss_of_params, p0, self.pv,
                                        steps=tr["steps"], lr=tr["lr"])
            finally:
                rec, self.recording = self.recording, None
            if not keep:
                return tr["steps"], None
            return tr["steps"], dict(v0=v, steps=rec, history=out.history,
                                     lr=tr["lr"])
        pv, dev = self.pv, self.device
        loss_of_vec = compiled(
            lambda x: self.loss_of_params(pv.to_params(p0, x)[0]))
        seen = []

        def f(x):
            val = float(loss_of_vec(torch.as_tensor(x, dtype=torch.float32,
                                                    device=dev)))
            seen.append((np.asarray(x, np.float64).copy(), val))
            return val

        x_best, f_best, hist = optimize_black_box(
            f, pv.bounds(), n_seeds=tr["n_seeds"], iters=tr["iters"],
            seed=fit_seed, x0=pv.to_vec(p0))
        if not keep:
            return len(hist), None
        return len(hist), dict(evals=seen, x_best=x_best, f_best=f_best)

    def warm(self) -> None:
        rng = stream(self.seed, WARM)
        self.fit(self.start(rng), int(rng.integers(2**31)), False)
        fence(self.device)

    def fits(self):
        """The window's fits, (start, fit seed) each: drawn from the run's
        seed, or, with a `pool` in the traffic, the pool's fits (made from
        the pool's own seed, the same in every run) in turn from a place
        the run's seed draws, so that every run's window holds the same
        work in another order."""
        pool = self.traffic.get("pool")
        if pool is None:
            rng = stream(self.seed, STARTS)
            while True:
                yield self.start(rng), int(rng.integers(2**31))
        rng = np.random.default_rng(pool["seed"])
        fits = [(self.start(rng), int(rng.integers(2**31)))
                for _ in range(pool["fits"])]
        k = int(stream(self.seed, STARTS).integers(len(fits)))
        while True:
            yield fits[k % len(fits)]
            k += 1

    def window(self, seconds: float, trace_calls: int) -> Window:
        win = Window()
        fits = self.fits()
        res = Reservoir(self.traffic["check"]["fits"], stream(self.seed,
                                                              CHECK))
        prof = Profiled(trace_calls, self.device)
        win.start = time.perf_counter()
        k = 0
        while k == 0 or time.perf_counter() - win.start < seconds:
            v, fit_seed = next(fits)
            slot = res.slot()
            t0 = time.perf_counter()
            with prof.span(k):
                n, rec = self.fit(v, fit_seed, slot is not None)
            win.latency_s.append(time.perf_counter() - t0)
            win.calls += 1
            win.attempted += 1
            win.evals += n
            prof.stop_after(k, win, 0, win.evals)
            if slot is not None:
                res.items[slot] = rec
            k += 1
        win.end = time.perf_counter()
        prof.close(win, 0, win.evals)
        win.kept = res.kept()
        return win

    def free(self) -> None:
        self._hook.remove()
        self.loss_of_params = None
        self.sys = self.sys._replace(scene=None)


def check(cell, win, conf, traffic, seed, device, limits):
    rng = stream(seed, CHECK + 100)
    per = []
    for rec in win.kept:
        if traffic["method"] == "gradient":
            per.append(CK.adam_numbers(cell.problem, cell.targets_u8, rec))
        else:
            picks = CK.bbox_pick(rec, traffic["check"]["evals"], rng)
            per.append(CK.bbox_numbers(cell.problem, cell.targets_u8, rec,
                                       picks))
    nums = {k: max(p[k] for p in per) for k in per[0]}
    failed = sum(any(p[k] > limits.get(k, math.inf) for k in p)
                 for p in per)
    return nums, failed


def _as_rec(ref: dict, lr: float) -> dict:
    """A reference's follow() in the shape of a kept fit's record."""
    return dict(history=ref["loss"], lr=lr,
                steps=[(ref["z"][k], ref["grad"][k] if k < 3 else None)
                       for k in range(4)])


def readings(cell, win, conf, traffic, seed, device) -> dict:
    """The program's numbers, the TF32 control's, the half batch's and
    (gradient) the unchanged state's, and the program's against float64."""
    R = reference(conf)
    rec = win.kept[0]
    p, tg = cell.problem, cell.targets_u8
    soup, om = cell.sys.soup, cell.sys.object_materials
    ctl = R.Problem.make(conf, soup, om, cell.poses, cell.draws, device,
                         tf32=True)
    p64 = R.Problem.make(conf, soup, om, cell.poses, cell.draws, device,
                         dtype=torch.float64)
    half = list(range((p.n_frames + 1) // 2))
    t0 = time.perf_counter()
    if traffic["method"] == "gradient":
        lr = rec["lr"]
        ref = p.follow(rec["v0"], tg, 3, lr)
        ref_s = time.perf_counter() - t0
        out = dict(program=CK.adam_numbers(p, tg, rec, ref))
        for name, r in (("control", ctl.follow(rec["v0"], tg, 3, lr)),
                        ("half_batch", p.follow(rec["v0"], tg, 3, lr,
                                                frames=half)),
                        ("unchanged", p.follow(rec["v0"], tg, 3, lr,
                                               frozen=True))):
            out[name] = CK.adam_numbers(p, tg, _as_rec(r, lr), ref)
        out["f64"] = CK.adam_numbers(p64, tg, rec)
        out["grads"] = dict(program=rec["steps"][0][1].tolist(),
                            reference=ref["grad"][0].tolist(),
                            f64=p64.follow(rec["v0"], tg, 1, lr)["grad"][0]
                            .tolist())
    else:
        picks = CK.bbox_pick(rec, traffic["check"]["evals"],
                             stream(seed, CHECK + 100))
        out = dict(program=CK.bbox_numbers(p, tg, rec, picks))
        ref_s = time.perf_counter() - t0

        def values(prob, frames=None):
            with torch.no_grad():
                return [float(prob.loss_v(torch.as_tensor(
                    rec["evals"][i][0], dtype=prob.dtype, device=device),
                    tg, frames)) for i in picks]

        out["control"] = CK.bbox_numbers(p, tg, rec, picks, values(ctl))
        out["half_batch"] = CK.bbox_numbers(p, tg, rec, picks,
                                            values(p, half))
        out["f64"] = CK.bbox_numbers(p64, tg, rec, picks)
    out["reference_s"] = ref_s
    return out
