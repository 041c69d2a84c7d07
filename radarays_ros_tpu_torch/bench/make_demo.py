"""Render the demo frame and its cartesian view (the twin of the JAX repo's
benchmarks/make_demo.py).

    python -m radarays_ros_tpu_torch.bench.make_demo [--device cpu]
        [--out build/demo_torch]

One full 400 x 3424 KAIST-preset frame over the canyon demo scene
(geom/primitives.py:make_canyon_scene with the reference's demo settings:
dense facades and street clutter, the KAIST02-class regime), written as
    <out>/demo_polar_kaist_preset.png  the polar frame;
    <out>/cartesian_kaist_demo.png     its papercolor cartesian view;
and one JSON line with the files, the frame's imaging statistics and the
frame's seconds. The PNGs never go to docs/.

Left out: the reference's real | ref-sim | ours panel and its imaging-
stats comparison, which cut their panels from the published figure
kaist02_radarays_papercolor.png; that figure is not in the repository.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from radarays_ros_tpu_torch.bench import common as C

# make_demo.py:33-34, the canyon demo scene
SCENE_KW = dict(n_blocks=12, street_w=12.0, block_len=18.0, seed=3,
                clutter=2.5)
PANEL_NOTE = ("left out: the real | ref-sim | ours panel and its imaging-"
              "stats comparison need the published figure "
              "kaist02_radarays_papercolor.png, which is not in the "
              "repository")


def read_back(path) -> np.ndarray:
    """The pixels of a PNG as io/image_io.py writes it (8-bit gray or RGB,
    one IDAT, filter none on every row): (H, W) or (H, W, 3) uint8. Raises
    if the file is not such a PNG or its data do not fill the image."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    ch = {0: 1, 2: 3}.get(color)
    n = struct.unpack(">I", data[33:37])[0]
    if depth != 8 or ch is None or data[37:41] != b"IDAT":
        raise ValueError(f"{path}: not an 8-bit gray or RGB PNG of one IDAT")
    raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row is filtered")
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def build_frame(dev, scene_kw: Optional[dict] = None,
                cfg_overrides: Optional[dict] = None) -> tuple:
    """The demo frame: (u8 polar image (n_cells, n_angles), its config,
    triangles, seconds of the frame)."""
    from radarays_ros_tpu_torch.geom.primitives import make_canyon_scene
    from radarays_ros_tpu_torch.geom.scene import Scene
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    parts, names = make_canyon_scene(**(scene_kw or SCENE_KW))
    scene = Scene.compose(parts, names, chunk_size=256)
    st = scene.to_device(dev)
    params = RadarParams.make(Materials.from_list([C.AIR, C.WALL],
                                                  device=dev),
                              np.ones(scene.n_objects, np.int32), 10.0)
    cfg = RadarModelConfig(**{**C.KAIST, "trace_aux_baked": False,
                              **(cfg_overrides or {})})
    gen = torch.Generator(dev).manual_seed(0)
    C.fence(dev)
    t0 = time.perf_counter()
    r = simulate_frame(st, params, cfg, torch.from_numpy(
        make_pose([0.0, 0.0, 2.0])), generator=gen)
    img = r.image_u8.cpu().numpy()
    return img, cfg, scene.n_triangles, time.perf_counter() - t0


def main(argv=None, *, scene_kw: Optional[dict] = None,
         cfg_overrides: Optional[dict] = None) -> dict:
    """scene_kw and cfg_overrides cut the frame to size (tests)."""
    from radarays_ros_tpu_torch.io.image_io import (write_png_gray,
                                                    write_png_rgb)
    from radarays_ros_tpu_torch.viz.cartesian import (colorize_papercolor,
                                                      imaging_stats,
                                                      polar_to_cartesian,
                                                      stretch_contrast)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    C.add_device_arg(ap)
    ap.add_argument("--out", default=str(C.BUILD / "demo_torch"))
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    img, cfg, n_tri, frame_s = build_frame(dev, scene_kw, cfg_overrides)
    polar = out / "demo_polar_kaist_preset.png"
    write_png_gray(polar, img)
    cart = polar_to_cartesian(img, size=800,
                              max_cell=int(round(90.0 / cfg.resolution)))
    cart_path = out / "cartesian_kaist_demo.png"
    write_png_rgb(cart_path, colorize_papercolor(stretch_contrast(cart)))
    stats = imaging_stats(img)
    return C.emit({
        "bench": "make_demo", "device": C.card_identity(dev),
        "scene": scene_kw or SCENE_KW, "n_triangles": n_tri,
        "frame_s": frame_s, "files": [str(polar), str(cart_path)],
        "ours": {k: stats[k] for k in (
            "noise_floor_mean", "noise_floor_std", "return_fraction",
            "dynamic_range_per_column_mean")},
        "panel": PANEL_NOTE})


if __name__ == "__main__":
    main()
