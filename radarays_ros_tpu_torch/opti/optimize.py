"""Material-property optimization (counterpart of
radarays_ros_tpu/opti/optimize.py, after scripts/radaray_opti.py).

  * `optimize_gradient` — Adam (torch.optim.Adam, whose defaults are
    optax.adam's: beta 0.9/0.999, eps 1e-8 added to sqrt(v_hat)) on a
    sigmoid-reparameterized vector, gradients flowing through the whole
    frame: cone directions -> trace refinement -> Fresnel -> shading ->
    binning (K5's backward). n_reflections is a static parameter held fixed
    per run (sweep it outside, `sweep_n_reflections`). Each step's loss
    and gradient are one compiled call, `value_and_grad` (a CUDA graph on
    the card, sim/graphs.py), as the reference jits its grad_fn;
    `compiled` is the same for a loss alone (the reference's
    jax.jit(loss_of_params)).
  * `optimize_black_box` — the reference's derivative-free fallback
    (Halton seeding + Nelder-Mead polish), NumPy, unchanged.

`ParamVector` mirrors the reference's to_param_vec/vec_to_params mapping
and bounds (radaray_opti.py:37-113) with configurable material slots.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from radarays_ros_tpu_torch.opti.metrics import psnr
from radarays_ros_tpu_torch.sim.config import RadarModelConfig, RadarParams
from radarays_ros_tpu_torch.sim.graphs import Compiled
from radarays_ros_tpu_torch.sim.pipeline import (float_u8_image,
                                                 simulate_frames)
from radarays_ros_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class ParamVector:
    """Pack/unpack RadarParams <-> bounded flat vector.

    Default layout and bounds follow radaray_opti.py:37-85: beam_width
    (0.01..20 deg), n_reflections (0..6), then 4 material scalars per tuned
    slot; tuned slots default to (1, 3) = wall, glass.
    """

    material_slots: Tuple[int, ...] = (1, 3)
    tune_n_reflections: bool = True
    tune_beam_width: bool = True
    beam_width_bounds: Tuple[float, float] = (0.01, 20.0)
    velocity_bounds: Tuple[float, float] = (0.0, 0.3)
    ambient_bounds: Tuple[float, float] = (0.0, 1.0)
    diffuse_bounds: Tuple[float, float] = (0.0, 1.0)
    specular_bounds: Tuple[float, float] = (0.0, 5000.0)

    @property
    def n(self) -> int:
        return (int(self.tune_beam_width) + int(self.tune_n_reflections)
                + 4 * len(self.material_slots))

    def bounds(self) -> np.ndarray:
        b = []
        if self.tune_beam_width:
            b.append(self.beam_width_bounds)
        if self.tune_n_reflections:
            b.append((0.0, 6.0))
        for _ in self.material_slots:
            b += [self.velocity_bounds, self.ambient_bounds,
                  self.diffuse_bounds, self.specular_bounds]
        return np.asarray(b, np.float64)

    def to_vec(self, params: RadarParams, n_reflections: int = 2
               ) -> np.ndarray:
        v = []
        if self.tune_beam_width:
            v.append(float(np.rad2deg(np.float32(float(params.beam_width)))))
        if self.tune_n_reflections:
            v.append(float(n_reflections))
        m = params.materials
        for s in self.material_slots:
            v += [float(m.velocity[s]), float(m.ambient[s]),
                  float(m.diffuse[s]), float(m.specular[s])]
        return np.asarray(v, np.float64)

    def to_params(self, params_init: RadarParams, vec
                  ) -> Tuple[RadarParams, int]:
        """Differentiable when `vec` is a tensor that requires grad: the
        tuned entries are written out of place."""
        m = params_init.materials
        dev = m.velocity.device
        vec = torch.as_tensor(vec, dtype=torch.float32, device=dev)
        off = int(self.tune_beam_width)
        n_reflections = 2
        if self.tune_n_reflections:
            n_reflections = int(round(float(vec[off])))
            off += 1
        cols = list(m)
        for i, s in enumerate(self.material_slots):
            # filled in on the device: no host copy a step
            ix = torch.full((1,), s, dtype=torch.int64, device=dev)
            for j in range(4):
                cols[j] = cols[j].index_put(
                    (ix,), vec[off + 4 * i + j].reshape(1))
        beam_width = (vec[0] * (math.pi / 180.0) if self.tune_beam_width
                      else params_init.beam_width)
        return RadarParams(type(m)(*cols), params_init.object_materials,
                           beam_width), n_reflections


def default_objective(scene, cfg: RadarModelConfig, poses, target_u8, *,
                      cone_draws=None, random_begin=None, uniform=None,
                      generator: Optional[torch.Generator] = None):
    """-PSNR(sim, real) over uint8-scale images, the reference's objective
    (radaray_opti.py:205), on `float_u8_image` (the per-column normalized
    float frame, whose gradient is not zeroed by the rounding of image_u8).

    poses (7,) with target_u8 (n_cells, n_angles) scores one frame; poses
    (N, 7) with targets (N, n_cells, n_angles) scores the mean of the N
    frames' -PSNR, rendered as one batch. The random inputs are those of
    simulate_frames (batched) and are held fixed across evaluations, as the
    reference holds its key: absent ones are drawn once here, from
    `generator` (a seed-0 generator on the scene's device by default).
    """
    dev = scene.device
    # on the device once, not copied there by every evaluation
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target_u8, dtype=torch.float32, device=dev)
    if poses.dim() == 1:
        def one(x):
            return None if x is None else torch.as_tensor(x)[None]

        poses, target, random_begin, uniform = map(
            one, (poses, target, random_begin, uniform))
        if cone_draws is not None:
            cone_draws = tuple(map(one, cone_draws))
    N, A = poses.shape[0], cfg.n_angles
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    if cone_draws is None:
        from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

        draws = [sample_cone_draws(generator, cfg.n_samples,
                                   cfg.beam_sample_dist) for _ in range(N)]
        cone_draws = tuple(torch.stack(d) for d in zip(*draws))
    if cfg.ambient_noise == 2 and random_begin is None:
        random_begin = torch.randint(0, 1000, (N, A), generator=generator,
                                     device=dev)
    if cfg.ambient_noise == 1 and uniform is None:
        uniform = torch.rand((N, A, cfg.n_cells), generator=generator,
                             device=dev)

    def objective(params: RadarParams):
        res = simulate_frames(scene, params, cfg, poses,
                              cone_draws=cone_draws,
                              random_begin=random_begin, uniform=uniform)
        img = float_u8_image(res, cfg)
        return -torch.stack([psnr(img[i], target[i])
                             for i in range(img.shape[0])]).mean()

    return objective


@dataclasses.dataclass
class OptResult:
    vec: np.ndarray
    value: float
    history: list
    params: RadarParams
    n_reflections: int


def _sigmoid_reparam(bounds: np.ndarray, device="cpu"):
    lo = torch.as_tensor(bounds[:, 0], dtype=torch.float32, device=device)
    hi = torch.as_tensor(bounds[:, 1], dtype=torch.float32, device=device)

    def to_vec(z):
        return lo + (hi - lo) * torch.sigmoid(z)

    def to_z(v):
        p = np.clip((np.asarray(v) - bounds[:, 0])
                    / (bounds[:, 1] - bounds[:, 0]), 1e-4, 1 - 1e-4)
        return torch.as_tensor(np.log(p / (1 - p)), dtype=torch.float32,
                               device=device)

    return to_vec, to_z


def step_loss_fn(loss_of_params: Callable[[RadarParams], torch.Tensor],
                 params_init: RadarParams, pv: ParamVector):
    """(z -> loss, to_vec, to_z): the loss of the reparameterized vector z
    that optimize_gradient descends (the reference's jitted step_loss)."""
    to_vec, to_z = _sigmoid_reparam(pv.bounds(),
                                    params_init.materials.velocity.device)

    def step_loss(z):
        params, _ = pv.to_params(params_init, to_vec(z))
        return loss_of_params(params)

    return step_loss, to_vec, to_z


def compiled(fn: Callable) -> Compiled:
    """fn (a function of tensors and NamedTuples of them, e.g. a loss of
    RadarParams) as a compiled call, without autograd: one CUDA graph a
    signature of its arguments on their card, eager on CPU tensors
    (sim/graphs.py) — the reference's jax.jit(loss_of_params)."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)

    return Compiled(run)


def value_and_grad(fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> Compiled:
    """z -> (fn(z), d fn / d z), detached, as one compiled call: the
    forward and the backward of fn in one CUDA graph on the card (the
    backward kernels, rr_bin_bwd and rr_table_grad, launch on the
    capturing stream), eager on the CPU — the reference's
    jax.jit(jax.value_and_grad(step_loss)) (opti/optimize.py:170-177).
    fn's closed-over tensors are read in place."""
    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            loss = fn(z)
            g, = torch.autograd.grad(loss, z)
        return loss.detach(), g

    return Compiled(vg)


def optimize_gradient(loss_of_params: Callable[[RadarParams], torch.Tensor],
                      params_init: RadarParams,
                      pv: Optional[ParamVector] = None,
                      steps: int = 100, lr: float = 5e-2,
                      verbose: bool = False) -> OptResult:
    """Adam on the sigmoid-reparameterized param vector, on the device of
    params_init. loss_of_params: differentiable scalar loss of RadarParams
    (e.g. from default_objective with cfg/n_reflections baked in). Each
    step's loss and gradient come from one compiled call
    (`value_and_grad`: a CUDA graph on the card); Adam's update is eager,
    as optax's is in the reference. Spans: the fit is `rr.fit.run`, each
    step's loss and gradient through `loss.item()` one `rr.fit.eval`
    (Adam's step lies outside it)."""
    pv = pv or ParamVector(tune_n_reflections=False)
    if pv.tune_n_reflections:
        raise ValueError(
            "optimize_gradient: tune_n_reflections reads the bounce count "
            "on the host in every loss, which the compiled step cannot (nor "
            "can the reference's jit): hold it fixed and sweep it outside "
            "(sweep_n_reflections)")
    with annotate("rr.fit.run"):
        step_loss, to_vec, to_z = step_loss_fn(loss_of_params, params_init,
                                               pv)
        grad_fn = value_and_grad(step_loss)
        z = to_z(pv.to_vec(params_init)).requires_grad_(True)
        opt = torch.optim.Adam([z], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        history = []
        best = (np.inf, z.detach().clone())
        for i in range(steps):
            with annotate("rr.fit.eval"):
                loss, z.grad = grad_fn(z)
                val = loss.item()
            history.append(val)
            if val < best[0]:
                best = (val, z.detach().clone())
            opt.step()
            if verbose and i % 10 == 0:
                print(f"step {i:4d}  loss {val:.4f}")
        with torch.no_grad():
            vec_t = to_vec(best[1])
            params, n_ref = pv.to_params(params_init, vec_t)
        return OptResult(vec=vec_t.cpu().numpy(), value=best[0],
                         history=history, params=params,
                         n_reflections=n_ref)


def optimize_black_box(f: Callable[[np.ndarray], float],
                       bounds: np.ndarray, *, n_seeds: int = 32,
                       iters: int = 60, seed: int = 0,
                       x0: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, float, list]:
    """Derivative-free global-ish minimize over a box (shgo stand-in).

    Phase 1: scrambled low-discrepancy seeding (+ optional x0); phase 2:
    Nelder-Mead polish from the best seed. Returns (x_best, f_best, history).
    Spans: the search is `rr.fit.run`, each call of f one `rr.fit.eval`.
    """
    def ev(x):
        with annotate("rr.fit.eval"):
            return float(f(x))

    with annotate("rr.fit.run"):
        rng = np.random.default_rng(seed)
        lo, hi = bounds[:, 0], bounds[:, 1]
        dim = bounds.shape[0]

        # Halton-like seeding
        def halton(i, base):
            f, r = 1.0, 0.0
            while i > 0:
                f /= base
                r += f * (i % base)
                i //= base
            return r

        primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37][:dim]
        shift = rng.uniform(size=dim)
        seeds = [lo + (hi - lo) * np.array(
            [(halton(i + 1, p) + s) % 1.0 for p, s in zip(primes, shift)])
            for i in range(n_seeds)]
        if x0 is not None:
            seeds.insert(0, np.clip(np.asarray(x0, np.float64), lo, hi))

        history = []
        evals = [(ev(x), x) for x in seeds]
        history += [v for v, _ in evals]
        evals.sort(key=lambda t: t[0])
        f_best, x_best = evals[0]

        # Nelder-Mead polish (standard coefficients, box-clipped)
        scale = (hi - lo) * 0.05
        simplex = [x_best] + [np.clip(x_best + scale * (np.arange(dim) == k),
                                      lo, hi) for k in range(dim)]
        fvals = [ev(x) for x in simplex]
        history += fvals
        for _ in range(iters):
            order = np.argsort(fvals)
            simplex = [simplex[i] for i in order]
            fvals = [fvals[i] for i in order]
            centroid = np.mean(simplex[:-1], axis=0)
            xr = np.clip(centroid + (centroid - simplex[-1]), lo, hi)
            fr = ev(xr)
            history.append(fr)
            if fr < fvals[0]:
                xe = np.clip(centroid + 2 * (centroid - simplex[-1]), lo, hi)
                fe = ev(xe)
                history.append(fe)
                simplex[-1], fvals[-1] = (xe, fe) if fe < fr else (xr, fr)
            elif fr < fvals[-2]:
                simplex[-1], fvals[-1] = xr, fr
            else:
                xc = np.clip(centroid + 0.5 * (simplex[-1] - centroid), lo,
                             hi)
                fc = ev(xc)
                history.append(fc)
                if fc < fvals[-1]:
                    simplex[-1], fvals[-1] = xc, fc
                else:  # shrink
                    for k in range(1, dim + 1):
                        simplex[k] = simplex[0] + 0.5 * (simplex[k]
                                                         - simplex[0])
                        fvals[k] = ev(simplex[k])
                    history += fvals[1:]
        order = np.argsort(fvals)
        if fvals[order[0]] < f_best:
            f_best, x_best = fvals[order[0]], simplex[order[0]]
        return np.asarray(x_best), float(f_best), history


def sweep_n_reflections(
        make_loss: Callable[[int], Callable[[RadarParams], torch.Tensor]],
        params_init: RadarParams, pv: Optional[ParamVector] = None,
        n_reflections_range: Sequence[int] = (1, 2, 3, 4), **kw
) -> OptResult:
    """Outer sweep over the static bounce count; inner gradient opt."""
    pv = pv or ParamVector(tune_n_reflections=False)
    best = None
    for n_ref in n_reflections_range:
        res = optimize_gradient(make_loss(n_ref), params_init, pv, **kw)
        res.n_reflections = n_ref
        if best is None or res.value < best.value:
            best = res
    return best
