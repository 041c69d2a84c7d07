"""`Radar` — the stateful simulator front-end (counterpart of
radarays_ros_tpu/sim/radar.py, after Radar.hpp:34-107).

Owns the scene tensors, materials, configuration and random streams on one
device; `simulate(pose)` returns one polar frame. The transmit cone's draws
are made once and kept across frames (the reference's cached cone key, after
m_waves_start, RadarCPU.cpp:136-145); the directions are rebuilt from them
with the current beam width every frame. New draws are made after
`resample()`, a beam-shape change in `update_config` (the m_resample
trigger, Radar.cpp:199-206) or a change of the sample count. Ambient noise
is drawn anew for every frame from its own generator; `simulate(...,
reseed=False)` restores that generator's state and so repeats the previous
frame's noise (the reference's reuse of its noise key).

Frames run through the compiled entry (`simulate_frame_jit`: a CUDA graph
a config and pose shape on the card, replayed with the new pose, draws and
params; pipeline.frames_entry picks the eager frame for the configs it
refuses), as the reference's Radar runs simulate_frame_jit.

Poses are explicit arguments, (7,) or (n_angles, 7) per azimuth for
include_motion. A frame without a pose is the pose-failure fallback of
Radar.cpp:102-121: with a stamp and the last two stamped poses it
extrapolates (`extrapolate_pose`), else it reuses the last pose.
`verbose_timing` fences and prints every frame's wall time, as the
reference engines do (RadarCPU.cpp:550-553).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from radarays_ros_tpu_torch.geom.scene import Scene, bake_tri_aux, with_planes
from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams, default_params)
from radarays_ros_tpu_torch.sim.pipeline import FrameResult, frames_entry
from radarays_ros_tpu_torch.utils.transforms import identity_pose
from radarays_ros_tpu_torch.wave.cone import sample_cone_draws


class Radar:
    def __init__(self, scene: Scene, params: Optional[RadarParams] = None,
                 cfg: Optional[RadarModelConfig] = None, seed: int = 0,
                 device="cuda", verbose_timing: bool = False):
        from radarays_ros_tpu_torch.utils.profiling import StageTimer

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Radar: no CUDA device; pass device='cpu' to "
                               "simulate on the host")
        self.timer = StageTimer()
        self.verbose_timing = verbose_timing
        self.scene = scene
        self._scene_tensors = scene.to_device(self.device)
        if params is None:
            params, default_cfg = default_params(scene.n_objects)
            cfg = cfg or default_cfg
        self.params = params.to(self.device)
        self.cfg = cfg or RadarModelConfig()
        self._cone_gen = torch.Generator(self.device).manual_seed(2 * seed)
        self._noise_gen = torch.Generator(self.device).manual_seed(2 * seed + 1)
        # the noise generator's state before the last frame's draw
        self._noise_state = self._noise_gen.get_state()
        self._cone_draws = None
        self._last_pose = identity_pose()
        # last two (stamp, pose) pairs for the extrapolation fallback
        self._pose_history: list[tuple[float, np.ndarray]] = []
        self._auto_opaque()
        self._bake_aux()
        self._engine_tables()

    # ------------------------------------------------------------ config

    def update_config(self, **kwargs) -> None:
        """Runtime reconfigure (dynamic_reconfigure equivalent); beam-shape
        fields trigger cone resampling (Radar.cpp:199-206)."""
        resample_keys = {"beam_sample_dist", "n_samples",
                         "beam_sample_dist_normal_p_in_cone"}
        if resample_keys & set(kwargs):
            self.resample()
        self.cfg = self.cfg.replace(**kwargs)
        self._engine_tables()

    def update_params(self, params: RadarParams,
                      resample: bool = False) -> None:
        self.params = params.to(self.device)
        if resample:
            self.resample()
        self._auto_opaque()
        self._bake_aux()

    def resample(self) -> None:
        """Make new cone draws for the next frame (m_resample = true)."""
        self._cone_draws = None

    def load_materials(self, entries, object_materials) -> None:
        """loadParams() equivalent (Radar.cpp:220-226)."""
        self.update_params(RadarParams(
            Materials.from_list(entries, device=self.device),
            torch.as_tensor(np.asarray(object_materials, np.int32),
                            device=self.device),
            self.params.beam_width))

    def _bake_aux(self) -> None:
        """Bake the object->material map into the scene's per-triangle aux
        column (clipped like the pipeline's gather), so each trace returns
        the hit's material without a per-bounce gather."""
        st = self._scene_tensors
        om = self.params.object_materials
        row = om.to(torch.float32)[
            torch.clamp(st.obj_ids, 0, om.shape[0] - 1).long()]
        self._scene_tensors = bake_tri_aux(st, row)
        if not self.cfg.trace_aux_baked:
            self.cfg = self.cfg.replace(trace_aux_baked=True)

    def _engine_tables(self) -> None:
        """The "mxu" engine's plane tables, made on the device once its
        engine is asked for (other engines do not need them)."""
        if self.cfg.trace_engine == "mxu":
            self._scene_tensors = with_planes(self._scene_tensors)

    def _auto_opaque(self) -> None:
        """Set opaque_materials when it is provably exact: every non-air
        material has velocity 0, so Fresnel transmits nothing."""
        vel = self.params.materials.velocity.cpu().numpy()
        mask = np.ones(vel.shape[0], bool)
        air = self.cfg.material_id_air
        if 0 <= air < vel.shape[0]:
            mask[air] = False
        opaque = bool(np.all(vel[mask] == 0.0)) if mask.any() else False
        if opaque != self.cfg.opaque_materials:
            self.cfg = self.cfg.replace(opaque_materials=opaque)

    # ------------------------------------------------------------ simulate

    def extrapolate_pose(self, stamp: Optional[float]) -> np.ndarray:
        """Pose-failure fallback (Radar.cpp:102-121 reuses the last cached
        pose). With the last two stamped poses cached, the translation is
        extrapolated linearly and the rotation slerp-extrapolated to
        `stamp`; with fewer, or no stamp, the last pose verbatim."""
        if stamp is not None and len(self._pose_history) == 2:
            (s0, p0), (s1, p1) = self._pose_history
            if s1 > s0:
                from radarays_ros_tpu_torch.io.trajectory import _slerp

                a = (float(stamp) - s0) / (s1 - s0)
                t = p0[0:3] + (p1[0:3] - p0[0:3]) * np.float32(a)
                q = _slerp(p0[3:7].astype(np.float64),
                           p1[3:7].astype(np.float64), a)
                return np.concatenate([t, q.astype(np.float32)])
        return self._last_pose

    def simulate(self, pose=None, *, stamp: Optional[float] = None,
                 reseed: bool = True) -> FrameResult:
        """One frame at a (7,) [t, q_xyzw] pose or (n_angles, 7) per-azimuth
        poses; None is the fallback of `extrapolate_pose` (with `stamp`) or
        the last pose. A stamp given with a (7,) pose is kept for later
        extrapolation. reseed=False repeats the previous frame's noise."""
        if pose is None:
            pose = self.extrapolate_pose(stamp)
        elif stamp is not None:
            p = np.asarray(pose, np.float32)
            if p.ndim == 1:
                self._pose_history.append((float(stamp), p.copy()))
                del self._pose_history[:-2]
        self._last_pose = np.asarray(pose, np.float32)
        if reseed:
            self._noise_state = self._noise_gen.get_state()
        else:
            self._noise_gen.set_state(self._noise_state)
        cfg = self.cfg
        if self._cone_draws is None \
                or self._cone_draws[0].shape[0] != cfg.n_samples:
            self._cone_draws = sample_cone_draws(
                self._cone_gen, cfg.n_samples, cfg.beam_sample_dist)
        t0 = time.perf_counter()
        # the compiled frame (a CUDA graph a config on the card), as the
        # reference's simulate_frame_jit; eager for the configs it refuses
        frame = frames_entry(cfg, self.device, batched=False)
        res = frame(self._scene_tensors, self.params, cfg,
                    torch.as_tensor(self._last_pose),
                    cone_draws=self._cone_draws, generator=self._noise_gen)
        if self.verbose_timing:
            # the per-frame print of the reference engines
            # (RadarCPU.cpp:550-553); fenced, so only when asked for (on
            # max_val, which stays on the card where the compiled frame's
            # u8 image comes back on the host)
            if res.max_val.is_cuda:
                torch.cuda.synchronize(res.max_val.device)
            dt = time.perf_counter() - t0
            self.timer.add("frame", dt)
            n = self.timer.counts["frame"]
            print(f"[radar] {dt * 1e3:8.2f} ms (avg "
                  f"{self.timer.totals['frame'] / n * 1e3:.2f} ms over {n} "
                  "frames)")
        return res

    def simulate_image(self, pose=None, **kwargs) -> np.ndarray:
        """uint8 (n_cells, n_angles) numpy polar image."""
        return self.simulate(pose, **kwargs).image_u8.cpu().numpy()
