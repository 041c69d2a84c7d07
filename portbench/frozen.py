"""Frozen copies of the sound measurement arithmetic of the port's own
measurement programs, so that a later change to the port cannot move the
yardstick. Each names its source.
"""

from __future__ import annotations

import re
import subprocess

import torch

# radarays_ros_tpu_torch/bench/common.py:34-52 (bench.py:137-176): air,
# opaque wall-stone, and the MulRan KAIST02 preset
AIR = dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0)
WALL = dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)
KAIST = dict(
    n_angles=400, n_cells=3424, resolution=0.0595238, n_samples=50,
    n_reflections=4, beam_sample_dist=2,
    beam_sample_dist_normal_p_in_cone=0.8, energy_max=0.72,
    signal_max=110.0, signal_denoising=1,
    signal_denoising_triangular_width=35,
    signal_denoising_triangular_mode=0.35, ambient_noise=2,
    ambient_noise_at_signal_0=0.1, ambient_noise_at_signal_1=0.03,
    ambient_noise_energy_max=0.1, ambient_noise_energy_min=0.05,
    record_multi_reflection=True, record_multi_path=False,
    opaque_materials=True, trace_engine="kernel", trace_ray_block=2048,
    draw_method="auto", trace_aux_baked=True)


class NoCard(RuntimeError):
    """The run asked for cards the machine does not have."""


def require_cards(n: int) -> torch.device:
    """The device rule of bench/common.py:76-85: a measurement runs on the
    card and never carries on on the CPU. Raises NoCard unless
    torch.cuda.is_available() and at least n cards are present."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {n}")
    return torch.device("cuda", 0)


def card_identity(dev: torch.device) -> str:
    """bench/common.py:88-96: the card's name and power limit as nvidia-smi
    prints them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)
    return out[(dev.index or 0) % len(out)]


def group_name(name: str) -> str:
    """bench/profile_frame.py:39-45: a kernel's group, its name without a
    leading "void " and anonymous namespaces, up to the first '<' or '('
    (template arguments, argument list), at most 60 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:60]


def busy(spans) -> tuple:
    """bench/profile_frame.py:48-55: (busy, window) of the union of the
    (start, end) ranges, in their unit."""
    total, end = 0.0, float("-inf")
    spans = sorted(spans)
    for a, b in spans:
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total, end - spans[0][0]
