"""Checkpoint/resume for optimization runs (counterpart of
radarays_ros_tpu/opti/checkpoint.py).

One .npz with the reference's keys — velocity, ambient, diffuse, specular,
object_materials, beam_width [rad], step, and optionally vec, history and
meta_* — written atomically (temporary file + rename). A checkpoint of
either package loads in the other, so this is also how fitted parameters
carry between them; `params_from_numpy` (sim/config.py) is the function for
parameters held in memory.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from radarays_ros_tpu_torch.sim.config import RadarParams, params_from_numpy


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_checkpoint(path, params: RadarParams, *, vec=None, history=None,
                    step: int = 0, meta: Optional[dict] = None) -> None:
    """Atomically write an optimization checkpoint."""
    path = Path(path)
    m = params.materials
    payload = {
        "velocity": _np(m.velocity),
        "ambient": _np(m.ambient),
        "diffuse": _np(m.diffuse),
        "specular": _np(m.specular),
        "object_materials": _np(params.object_materials),
        "beam_width": _np(params.beam_width),
        "step": np.int64(step),
    }
    if vec is not None:
        payload["vec"] = _np(vec)
    if history is not None:
        payload["history"] = np.asarray(history, np.float64)
    if meta:
        for k, v in meta.items():
            payload[f"meta_{k}"] = np.asarray(v)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path, device="cpu") -> Tuple[RadarParams, dict]:
    """Load a checkpoint -> (RadarParams on `device`, extras dict with
    step and, where saved, vec, history and the meta_* entries)."""
    with np.load(path) as z:
        params = params_from_numpy(
            z["velocity"], z["ambient"], z["diffuse"], z["specular"],
            z["object_materials"], z["beam_width"], device=device)
        extras = {"step": int(z["step"])}
        for k in ("vec", "history"):
            if k in z:
                extras[k] = z[k]
        for k in z.files:
            if k.startswith("meta_"):
                extras[k[5:]] = z[k]
    return params, extras
