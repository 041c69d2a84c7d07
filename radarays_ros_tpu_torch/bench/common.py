"""What the port's measurement programs share (the twins of the JAX repo's
bench.py and benchmarks/): the device rule, the card's identity, the
fenced and sustained timers, the kernel launch counters, the KAIST
benchmark preset over the urban scene (bench.py:119-182) and the radar fan.

The device rule: a twin runs on the card unless it is given `--device
cpu`; without a card and without `--device cpu` it raises. It never
carries on on the CPU. On the CPU the kernel wrappers run their plain
versions and count no launch, so a twin's `kernel_launches` of 0 says
that no kernel ran.

Outputs: a twin writes only under the repository's build/ directory or to
a path its caller gives (`BUILD`).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

import radarays_ros_tpu_torch  # noqa: F401  (switches TF32 off)

BUILD = Path(__file__).resolve().parents[2] / "build"

# bench.py:137-141: air, and opaque wall-stone on every object
AIR = dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0)
WALL = dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)

# bench.py:145-176, the MulRan KAIST02 preset (cfg/mulran_kaist_dyncfg.yaml);
# the reference's engine pallas3 and draw method pallas are the port's
# "kernel" and "auto"
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

# the kernel wrappers' names in kernel_launches: K1, K2, K3, K4, K5, K5's
# backward and the material lookup's backward
KERNELS = ("sweep", "prep_hier", "coarse_words", "prep_flat", "bin",
           "bin_bwd", "table_grad")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(record: dict) -> dict:
    """Print one JSON line on stdout; returns the record."""
    print(json.dumps(record), flush=True)
    return record


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions, for tests)")


def resolve_device(name: str) -> torch.device:
    """The twin's device: a card, or the CPU only when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench twins measure the "
                           "card; pass --device cpu to run the plain "
                           "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: expected cuda or cpu")
    return dev


def card_identity(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[(dev.index or 0) % len(out)]


def child_env(**extra) -> dict:
    """The environment of a twin run in a child process: this one's, the
    repository root on PYTHONPATH, and `extra`."""
    path = os.pathsep.join(p for p in (str(BUILD.parent),
                                       os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, **extra)


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fenced_times(run: Callable[[int], torch.Tensor], n: int,
                 dev: torch.device) -> tuple:
    """bench.py's fenced protocol: each call run(i) returns its batch's
    checksum on the device, fetched before the clock stops. Returns (the
    seconds of each call, the checksums)."""
    times, sums = [], []
    for i in range(n):
        fence(dev)
        t0 = time.perf_counter()
        sums.append(int(run(i)))
        times.append(time.perf_counter() - t0)
    return times, sums


def sustained_s(run: Callable[[int], torch.Tensor], n: int,
                dev: torch.device) -> tuple:
    """bench.py's streaming protocol: n calls queued back to back, every
    checksum fetched at the end. Returns (seconds, the checksums)."""
    fence(dev)
    t0 = time.perf_counter()
    outs = [run(i) for i in range(n)]
    sums = torch.stack(outs).tolist()
    return time.perf_counter() - t0, sums


def best_and_trimmed(times: list) -> tuple:
    """(best, trimmed median) of call seconds (bench.py:226-229)."""
    ts = sorted(times)
    trimmed = ts[1:-1] if len(ts) > 2 else ts
    return ts[0], float(np.median(trimmed))


def zero_launches() -> None:
    from radarays_ros_tpu_torch.sim.graphs import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    """Each kernel's launches since zero_launches (its wrapper's count;
    a compiled call's replays count the launches its graph recorded)."""
    from radarays_ros_tpu_torch.sim.graphs import launch_counts

    return launch_counts()


def radar_fan(n_rays: int, seed: int = 0, el_std: float = 0.06):
    """The coherent radar fan of bench.py:78-85 (sweep_kernel_ab.py:30):
    400 azimuths x n_rays // 400 elevations ~ N(0, el_std) from
    default_rng(seed), from (0, 0, 2). Returns numpy (o, d)."""
    rng = np.random.default_rng(seed)
    A = 400
    S = n_rays // A
    az = np.repeat(np.linspace(0, 2 * np.pi, A, endpoint=False), S)
    el = np.tile(rng.normal(0, el_std, S), A)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), d.shape).copy()
    return o, d


def on(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


_URBAN: dict = {}


def urban_scene(n_buildings: int, extent: float, seed: int,
                chunk_size: int = 256):
    """make_urban_scene(n_buildings, extent, seed) composed as a Scene. The
    last two soups generated are kept: an A/B that builds the gate's scene
    and the bench scene at several chunk sizes generates each once."""
    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene

    key = (n_buildings, float(extent), seed)
    if key not in _URBAN:
        while len(_URBAN) >= 2:
            del _URBAN[next(iter(_URBAN))]
        parts, names = make_urban_scene(n_buildings=n_buildings,
                                        extent=extent, seed=seed)
        _URBAN[key] = Scene.compose(parts, names)
    s = _URBAN[key]
    return type(s)(s.verts, s.obj_ids, s.object_names, chunk_size)


class Benchmark(NamedTuple):
    scene: object        # SceneTensors on the device, material map baked
    params: object       # RadarParams
    cfg: object          # RadarModelConfig
    host: object         # the SceneHost it was uploaded from


def build_benchmark(n_buildings: int, extent: float = 300.0, *,
                    cfg_overrides: Optional[dict] = None,
                    chunk_size: int = 256, device) -> Benchmark:
    """bench.py:build_benchmark: the KAIST preset over make_urban_scene(
    n_buildings, extent, seed=7), opaque wall-stone on every object, beam
    width 10 deg, the material map baked — through the host builder
    (native by default) and the scene cache (geom/cache.py, default cache
    directory; on from 200k triangles, as the reference's
    device_arrays)."""
    from radarays_ros_tpu_torch.geom.scene import bake_tri_aux, scene_tensors
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)

    dev = torch.device(device)
    t0 = time.perf_counter()
    scene = urban_scene(n_buildings, extent, 7, chunk_size)
    t1 = time.perf_counter()
    host = scene.host_arrays()
    t2 = time.perf_counter()
    st = scene_tensors(host, dev)
    n_obj = scene.n_objects
    params = RadarParams.make(Materials.from_list([AIR, WALL], device=dev),
                              np.ones(n_obj, np.int32), beam_width_deg=10.0)
    st = bake_tri_aux(st, params.object_materials.float()[
        st.obj_ids.clamp(0, n_obj - 1).long()])
    fence(dev)
    t3 = time.perf_counter()
    cfg = RadarModelConfig(**KAIST)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    log(f"bench: scene {st.n_triangles} tris: gen {t1 - t0:.1f}s, host "
        f"build {t2 - t1:.1f}s, upload {t3 - t2:.1f}s")
    return Benchmark(st, params, cfg, host)


def frame_checksum(res) -> torch.Tensor:
    """A batch's checksum where its u8 image lies: the sum of its u8
    pixels, on the device for an eager batch and on the host for a
    compiled one on the card (complete on return); fetching it fences
    the batch either way."""
    return res.image_u8.sum(dtype=torch.int64)
