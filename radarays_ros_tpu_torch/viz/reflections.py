"""2-D multi-media ray explorer data (counterpart of
radarays_ros_tpu/viz/reflections.py, after the reference's
scripts/reflections/{fresnel,snell_multi}.py).

Shoots one 2-D ray at a stack of horizontal media interfaces and returns
the growing reflect/refract ray tree as plain segment lists, through the
port's own Snell/Fresnel physics (wave/fresnel.py). The 2-D (x, y) plane
embeds as the 3-D xz-plane (y = 0); interfaces are lines y = depth with
the upper medium above.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from radarays_ros_tpu_torch.wave.fresnel import fresnel_split


def propagate_slab_rays(depths: Sequence[float], velocities: Sequence[float],
                        origin=(0.0, 1.0), direction=(0.6, -0.8),
                        n_bounces: int = 4, energy_threshold: float = 1e-3,
                        polarization: float = 0.5, device="cuda") -> Dict:
    """Propagate one 2-D ray through a stack of horizontal interfaces.

    depths: interface y-coordinates, strictly decreasing; velocities:
    len(depths) + 1 wave velocities, top medium first; origin/direction:
    the 2-D start ray (direction need not be normalized); n_bounces: the
    tree depth; energy_threshold: children below it are dropped (the
    engines' pruning threshold, Radar.cpp:24).

    Returns {"segments": [{p0, p1, energy, medium}...], "leaks": [...]}
    where `leaks` are rays that left the stack or were not terminated.
    """
    depths = list(depths)
    velocities = list(velocities)
    if len(velocities) != len(depths) + 1:
        raise ValueError("need len(depths) + 1 velocities")

    def medium_of(y: float) -> int:
        return sum(y < d for d in depths)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    d0 = np.asarray(direction, float)
    d0 = d0 / np.linalg.norm(d0)
    rays = [dict(p=np.asarray(origin, float), d=d0, e=1.0,
                 medium=medium_of(origin[1]))]
    segments: List[Dict] = []
    leaks: List[Dict] = []
    n3 = f32([0.0, 0.0, 1.0])          # interface normal +z (up)

    for _ in range(n_bounces):
        nxt = []
        for ray in rays:
            p, d, m = ray["p"], ray["d"], ray["medium"]
            # the nearest horizontal interface along the ray
            best_t, best_i = np.inf, None
            for i, depth in enumerate(depths):
                if abs(d[1]) < 1e-12:
                    continue
                t = (depth - p[1]) / d[1]
                if 1e-9 < t < best_t:
                    best_t, best_i = t, i
            if best_i is None:
                leaks.append(dict(p0=p.tolist(), dir=d.tolist(),
                                  energy=ray["e"], medium=m))
                continue
            hit = p + best_t * d
            segments.append(dict(p0=p.tolist(), p1=hit.tolist(),
                                 energy=ray["e"], medium=m))
            other = best_i + 1 if d[1] < 0 else best_i   # medium across
            fres = fresnel_split(
                n3, f32([d[0], 0.0, d[1]]), f32(ray["e"]), f32(polarization),
                f32(velocities[m]), f32(velocities[other]))
            er = float(fres.reflection_energy)
            et = float(fres.refraction_energy)
            rd = fres.reflection_dir.cpu().numpy()
            td = fres.refraction_dir.cpu().numpy()
            eps = 1e-6
            if er > energy_threshold:
                d2 = np.array([rd[0], rd[2]])
                nxt.append(dict(p=hit + eps * d2, d=d2, e=er, medium=m))
            if et > energy_threshold and float(td @ td) > 0.25:
                d2 = np.array([td[0], td[2]])
                d2 = d2 / np.linalg.norm(d2)
                nxt.append(dict(p=hit + eps * d2, d=d2, e=et, medium=other))
        rays = nxt
        if not rays:
            break
    for ray in rays:  # un-terminated tails
        leaks.append(dict(p0=ray["p"].tolist(), dir=ray["d"].tolist(),
                          energy=ray["e"], medium=ray["medium"]))
    return {"segments": segments, "leaks": leaks}
