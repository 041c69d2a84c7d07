"""The GenRadarImage workload (counterpart of
radarays_ros_tpu/opti/workload.py): the reference's GetRadarParams service
and GenRadarImage action (srv/GetRadarParams.srv, action/GenRadarImage.action)
served natively on a `Radar`. Message dicts use the field names of
msg/RadarMaterial.msg, msg/RadarModel.msg and msg/RadarParams.msg.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from radarays_ros_tpu_torch.sim.config import Materials, RadarParams
from radarays_ros_tpu_torch.sim.radar import Radar


def params_to_msg(params: RadarParams, n_samples: int,
                  n_reflections: int) -> dict:
    """RadarParams -> msg-shaped dict (msg/RadarParams.msg layout)."""
    m = params.materials
    return {
        "materials": {
            "data": [
                {
                    "velocity": float(m.velocity[i]),
                    "ambient": float(m.ambient[i]),
                    "diffuse": float(m.diffuse[i]),
                    "specular": float(m.specular[i]),
                }
                for i in range(m.velocity.shape[0])
            ]
        },
        "model": {
            "beam_width": float(np.rad2deg(np.float32(
                float(params.beam_width)))),
            "n_samples": int(n_samples),
            "n_reflections": int(n_reflections),
        },
    }


def msg_to_params(msg: dict, object_materials, device="cpu"
                  ) -> tuple[RadarParams, int, int]:
    """msg-shaped dict -> (RadarParams on `device`, n_samples,
    n_reflections)."""
    mats = Materials.from_list(msg["materials"]["data"], device=device)
    model = msg.get("model", {})
    params = RadarParams.make(
        mats, torch.as_tensor(object_materials).cpu().numpy(),
        beam_width_deg=float(model.get("beam_width", 8.0)))
    return (params, int(model.get("n_samples", 200)),
            int(model.get("n_reflections", 2)))


class RadarImageServer:
    """Native GenRadarImage action server + GetRadarParams service."""

    def __init__(self, radar: Radar):
        self.radar = radar

    def get_radar_params(self) -> dict:
        """GetRadarParams.srv equivalent."""
        return params_to_msg(self.radar.params, self.radar.cfg.n_samples,
                             self.radar.cfg.n_reflections)

    def gen_radar_image(self, goal_params: Optional[dict] = None,
                        pose=None) -> np.ndarray:
        """GenRadarImage.action equivalent: apply the goal's parameters
        (they persist, as the action server re-loads params per goal) and
        render one polar frame."""
        if goal_params is not None:
            params, n_samples, n_reflections = msg_to_params(
                goal_params, self.radar.params.object_materials,
                device=self.radar.device)
            if (n_samples != self.radar.cfg.n_samples
                    or n_reflections != self.radar.cfg.n_reflections):
                self.radar.update_config(n_samples=n_samples,
                                         n_reflections=n_reflections)
            self.radar.update_params(params)
        return self.radar.simulate_image(pose)
