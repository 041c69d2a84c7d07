"""Wave bundle types — structure-of-arrays (counterpart of
radarays_ros_tpu/wave/types.py).

A `Waves` NamedTuple of tensors with a shared leading batch shape, plus an
explicit `valid` mask in place of the reference CPU engine's dynamic-list
energy pruning (RadarCPU.cpp:288-370).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Waves(NamedTuple):
    """Batch of directed waves. All fields share the leading batch shape."""

    orig: torch.Tensor          # (..., 3) float32 — ray origin
    dir: torch.Tensor           # (..., 3) float32 — ray direction (unit)
    energy: torch.Tensor        # (...,)   float32
    polarization: torch.Tensor  # (...,)   float32 — 1=s, 0=p, 0.5=unpolarized
    velocity: torch.Tensor      # (...,)   float32 — speed in medium [m/ns]
    time: torch.Tensor          # (...,)   float32 — travel time [ns]
    material_id: torch.Tensor   # (...,)   int32   — current medium
    valid: torch.Tensor         # (...,)   bool    — alive mask

    @property
    def batch_shape(self):
        return tuple(self.energy.shape)

    def move(self, distance) -> "Waves":
        """orig += dir * d; time += d / velocity (radar_types.h:108-113)."""
        # a Python distance is filled in on the device (no host copy a
        # bounce, so a CUDA graph can hold it): the same f32 value as
        # as_tensor would copy there
        d = distance if torch.is_tensor(distance) else torch.full(
            (), distance, dtype=self.orig.dtype, device=self.orig.device)
        return self._replace(
            orig=self.orig + self.dir * d[..., None],
            time=self.time + d / self.velocity,
        )


def make_start_wave_attrs(*, energy: float = 1.0, polarization: float = 0.5,
                          velocity: float = 0.3, material_id: int = 0,
                          time: float = 0.0) -> dict:
    """Non-geometric attributes of the transmit wave (RadarCPU.cpp:106-114):
    unit energy, unpolarized, air speed 0.3 m/ns, air material, time 0."""
    return dict(energy=energy, polarization=polarization, velocity=velocity,
                material_id=material_id, time=time)


def broadcast_waves(orig, dir, attrs: dict, batch_shape) -> Waves:
    """Build a Waves bundle from geometry plus scalar attributes."""
    batch_shape = tuple(batch_shape)
    orig_b = torch.broadcast_to(orig, batch_shape + (3,)).to(torch.float32)
    dir_b = torch.broadcast_to(dir, batch_shape + (3,)).to(torch.float32)
    dev = orig_b.device

    def full(v, dtype=torch.float32):
        return torch.full(batch_shape, v, dtype=dtype, device=dev)

    return Waves(
        orig=orig_b.contiguous(),
        dir=dir_b.contiguous(),
        energy=full(attrs["energy"]),
        polarization=full(attrs["polarization"]),
        velocity=full(attrs["velocity"]),
        time=full(attrs["time"]),
        material_id=full(attrs["material_id"], torch.int32),
        valid=full(True, torch.bool),
    )
