"""Configuration model (counterpart of radarays_ros_tpu/sim/config.py).

  * `Materials`        — SoA material table as torch tensors
                          (RadarMaterial.msg: velocity, ambient, diffuse,
                          specular per material).
  * `RadarParams`      — materials + object->material map + beam width.
  * `AmbientNoiseParams` — radar_types.h:123-131 defaults.
  * `RadarModelConfig` — a copy of the reference's frozen dataclass with the
                          same field names and defaults (the reference
                          module imports jax and cannot be imported here).
                          TPU-only engine knobs are kept so that a config
                          round-trips between the two packages; the port
                          reads the ones listed in its docstring.
  * `params_from_numpy` — the reference's parameters (as numpy arrays) in
                          the port's form, for parity tests and callers
                          that hold both.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Materials(NamedTuple):
    """SoA material table."""

    velocity: torch.Tensor  # (M,) wave speed in medium [m/ns]
    ambient: torch.Tensor   # (M,) back-reflection base term
    diffuse: torch.Tensor   # (M,) back-reflection cosine factor
    specular: torch.Tensor  # (M,) back-reflection cosine exponent

    @staticmethod
    def from_list(entries: Sequence[dict], device="cpu") -> "Materials":
        """Build from dicts with velocity/ambient/diffuse/specular keys."""
        def col(k):
            return torch.tensor([float(e.get(k, 0.0)) for e in entries],
                                dtype=torch.float32, device=device)
        return Materials(col("velocity"), col("ambient"), col("diffuse"),
                         col("specular"))

    @staticmethod
    def air_only(device="cpu") -> "Materials":
        return Materials.from_list([
            dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
        ], device=device)

    @property
    def n(self) -> int:
        return self.velocity.shape[0]


class RadarParams(NamedTuple):
    """Dynamic simulation parameters (RadarParams.msg equivalent)."""

    materials: Materials
    object_materials: torch.Tensor  # (n_objects,) int32 object -> material
    beam_width: torch.Tensor        # () float32 [radians]

    @staticmethod
    def make(materials: Materials, object_materials,
             beam_width_deg: float = 8.0) -> "RadarParams":
        device = materials.velocity.device
        return RadarParams(
            materials=materials,
            object_materials=torch.as_tensor(
                np.asarray(object_materials, np.int32), device=device),
            beam_width=torch.tensor(np.float32(np.deg2rad(beam_width_deg)),
                                    device=device),
        )

    def to(self, device) -> "RadarParams":
        return RadarParams(
            Materials(*(t.to(device) for t in self.materials)),
            self.object_materials.to(device), self.beam_width.to(device))


def params_from_numpy(velocity, ambient, diffuse, specular, object_materials,
                      beam_width, device="cpu") -> RadarParams:
    """The reference's RadarParams fields (as numpy arrays, e.g.
    np.asarray(p.materials.velocity)) -> the port's RadarParams. beam_width
    is in radians, as the reference stores it."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return RadarParams(
        Materials(f32(velocity), f32(ambient), f32(diffuse), f32(specular)),
        torch.as_tensor(np.array(object_materials, np.int32), device=device),
        f32(beam_width).reshape(()))


@dataclasses.dataclass(frozen=True)
class AmbientNoiseParams:
    """Defaults of radar_types.h:123-131 (used by the reference GPU path)."""

    noise_at_signal_0: float = 0.1
    noise_at_signal_1: float = 0.03
    noise_energy_min: float = 0.05
    noise_energy_max: float = 0.08
    noise_energy_loss: float = 0.05
    resolution: float = 0.0595238


@dataclasses.dataclass(frozen=True)
class RadarModelConfig:
    """Static frame configuration; fields and defaults as the reference's
    RadarModelConfig (cfg/RadarModel.cfg:11-85 plus engine knobs).

    The port reads the model/simulation/denoise/noise fields, n_angles,
    material_id_air, wave_energy_threshold, skip_dist, reflection_model,
    opaque_materials, trace_engine ("auto" | "brute" | "sweep" |
    "kernel" | "mxu"; from_dict maps the reference's names,
    `port_engine`), draw_method ("auto" | "plain"; from_dict maps the
    reference's "scatter", "sort" and "pallas" to "auto",
    `port_draw_method`), trace_ray_block, trace_prep_group,
    trace_aux_baked, trace_two_phase_cap (the sweep engines), trace_k_chunks
    (the "sweep" engine, as the reference's culled) and trace_tri_chunk
    ("mxu"). trace_scene_axis names the mesh axis of a scene-sharded
    layout (parallel/sharding.py): where a layout has registered a group
    under that name (parallel/groups.py), every bounce merges the ranks'
    trace winners over it; elsewhere it is read and ignored. Read and
    ignored: trace_argmin_mode and trace_term_stride (pallas3 variants
    that are exact with bit-identical results, measured dead ends not
    ported, ROADMAP.md M8).
    """

    z_offset: float = 0.0
    range_min: float = 0.0
    range_max: float = 600.0
    resolution: float = 0.0438
    n_cells: int = 3424

    n_samples: int = 10
    beam_sample_dist: int = 2                      # 0..3 = D1..D4
    beam_sample_dist_normal_p_in_cone: float = 0.8
    n_reflections: int = 4

    energy_min: float = 0.0
    energy_max: float = 0.5
    signal_max: float = 120.0

    signal_denoising: int = 1                      # 0 none, 1 tri, 2 gauss, 3 MB
    signal_denoising_triangular_width: int = 50
    signal_denoising_triangular_mode: float = 0.35
    signal_denoising_gaussian_width: int = 50
    signal_denoising_gaussian_mode: float = 0.5
    signal_denoising_mb_width: int = 50
    signal_denoising_mb_mode: float = 0.4

    ambient_noise: int = 2                         # 0 none, 1 uniform, 2 perlin
    ambient_noise_at_signal_0: float = 0.3
    ambient_noise_at_signal_1: float = 0.03
    ambient_noise_energy_max: float = 0.5
    ambient_noise_energy_min: float = 0.1
    ambient_noise_energy_loss: float = 0.05
    ambient_noise_uniform_max: float = 0.15
    ambient_noise_perlin_scale_low: float = 0.05
    ambient_noise_perlin_scale_high: float = 0.2
    ambient_noise_perlin_p_low: float = 0.9

    scroll_image: int = 0
    multipath_threshold: float = 0.5
    record_multi_reflection: bool = True
    record_multi_path: bool = False
    include_motion: bool = False

    n_angles: int = 400
    material_id_air: int = 0
    wave_energy_threshold: float = 0.001           # Radar.cpp:24
    skip_dist: float = 0.001                       # RadarCPU.cpp:374
    reflection_model: str = "blinn_phong"          # or "cook_torrance"
    opaque_materials: bool = False
    draw_method: str = "auto"
    trace_engine: str = "auto"
    trace_ray_block: int = 2048
    trace_tri_chunk: int = 2048
    trace_k_chunks: Optional[int] = None
    trace_scene_axis: Optional[str] = None
    trace_prep_group: int = 0
    trace_aux_baked: bool = False
    trace_two_phase_cap: Optional[float] = None
    trace_argmin_mode: str = "gated"
    trace_term_stride: int = 1

    def denoiser(self) -> Tuple[Optional[np.ndarray], int]:
        """Use-time denoise kernel + mode (see image/denoise.py)."""
        from radarays_ros_tpu_torch.image.denoise import build_denoiser

        if self.signal_denoising == 1:
            return build_denoiser(1, self.signal_denoising_triangular_width,
                                  self.signal_denoising_triangular_mode)
        if self.signal_denoising == 2:
            return build_denoiser(2, self.signal_denoising_gaussian_width,
                                  self.signal_denoising_gaussian_mode)
        if self.signal_denoising == 3:
            return build_denoiser(3, self.signal_denoising_mb_width,
                                  self.signal_denoising_mb_mode)
        return None, 0

    def replace(self, **kwargs) -> "RadarModelConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def from_dict(d: dict) -> "RadarModelConfig":
        """Build from a flat dict of cfg names (preset YAML loader); unknown
        keys are ignored, and the reference's engine and draw method names
        are mapped to the port's (`port_engine`, `port_draw_method`), so a
        value the port cannot run raises here and not at the first
        frame."""
        fields = {f.name for f in dataclasses.fields(RadarModelConfig)}
        known = {k: v for k, v in d.items() if k in fields}
        if "trace_engine" in known:
            known["trace_engine"] = port_engine(known["trace_engine"])
        if "draw_method" in known:
            known["draw_method"] = port_draw_method(known["draw_method"])
        return RadarModelConfig(**known)


# the reference's trace engines that the port runs under another name
_ENGINE_ALIASES = {"pallas3": "kernel", "culled": "sweep"}


def port_engine(name: str) -> str:
    """A trace_engine name of either package -> the port's engine: the
    reference's "pallas3" (the Pallas kernels) is "kernel" here and its
    "culled" (the plain chunk sweep) is "sweep"; "mxu", "brute" and "auto"
    keep their names. Presets and commands written for the JAX package run
    unchanged."""
    return _ENGINE_ALIASES.get(name, name)


# the port's draw methods, and the reference's three binning methods, which
# its tests hold equal (tests/test_image.py:265), as the port's "auto" (the
# K5 wrapper)
_DRAW_METHODS = {"auto": "auto", "plain": "plain", "scatter": "auto",
                 "sort": "auto", "pallas": "auto"}


def port_draw_method(name: str) -> str:
    """A draw_method of either package -> the port's: "auto" and "plain"
    as they are, the reference's "scatter", "sort" and "pallas" as "auto";
    any other value raises."""
    if name not in _DRAW_METHODS:
        raise ValueError(
            f"unknown draw_method {name!r}: the port takes 'auto' or "
            "'plain', and the reference's 'scatter', 'sort' and 'pallas' "
            "(as 'auto')")
    return _DRAW_METHODS[name]


def default_params(scene_n_objects: int = 1, device="cpu"
                   ) -> Tuple[RadarParams, RadarModelConfig]:
    """Compiled-in defaults of ros_helper.h:21-35: beam 8 deg, 200 samples,
    2 reflections, air-only material table."""
    params = RadarParams.make(
        Materials.from_list([dict(velocity=0.3, ambient=1.0, diffuse=0.0,
                                  specular=1.0)], device=device),
        np.zeros(max(scene_n_objects, 1), np.int32), beam_width_deg=8.0)
    return params, RadarModelConfig(n_samples=200, n_reflections=2)
