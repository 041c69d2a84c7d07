"""Real-vs-sim evaluation harness (counterpart of
radarays_ros_tpu/opti/evaluate.py).

The reference scores simulation fidelity by replaying a bag and comparing
stamped real frames with synced simulated frames (radar_tools'
compare_radar_images.py in launch/tests/eval_real_to_sim.launch) and scores
PSNR in its optimizer (scripts/radaray_opti.py:205). This is that workflow
on files: pair the frames, compute the metric suite per pair on CPU tensors
(host frames need no device), and return a JSON-able report.

CLI: `python -m radarays_ros_tpu_torch.io.cli eval --real dir1 --sim dir2`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from radarays_ros_tpu_torch.opti.metrics import (
    mutual_information, normalized_mutual_information, psnr, ssim,
    variation_of_information)


def load_frame_dir(path) -> List[np.ndarray]:
    """Load all frames in a directory (sorted by name; .png or .npy)."""
    from radarays_ros_tpu_torch.io.image_io import read_png_gray

    frames = []
    for p in sorted(Path(path).iterdir()):
        if p.suffix == ".png":
            frames.append(read_png_gray(p))
        elif p.suffix == ".npy":
            frames.append(np.load(p))
    if not frames:
        raise ValueError(f"no frames (.png/.npy) in {path}")
    return frames


def compare_frames(real: np.ndarray, sim: np.ndarray,
                   metrics: Sequence[str] = ("psnr", "ssim")
                   ) -> Dict[str, float]:
    """Metric suite for one frame pair (shapes must match)."""
    if real.shape != sim.shape:
        raise ValueError(f"shape mismatch: real {real.shape} vs sim "
                         f"{sim.shape}")
    real_np = np.asarray(real, np.float32)
    sim_np = np.asarray(sim, np.float32)
    real_t, sim_t = torch.from_numpy(real_np), torch.from_numpy(sim_np)
    fns = {
        "psnr": lambda: float(psnr(real_t, sim_t)),
        "ssim": lambda: float(ssim(real_t, sim_t)),
        "mi": lambda: float(mutual_information(real_t, sim_t)),
        "nmi": lambda: float(normalized_mutual_information(real_t, sim_t)),
        "voi": lambda: float(variation_of_information(real_t, sim_t)),
        "mae": lambda: float(np.mean(np.abs(real_np - sim_np))),
    }
    return {m: fns[m]() for m in metrics}


def _summary(per_frame: List[dict], metrics: Sequence[str]) -> dict:
    return {
        m: {
            "mean": float(np.mean([f[m] for f in per_frame])),
            "std": float(np.std([f[m] for f in per_frame])),
            "min": float(np.min([f[m] for f in per_frame])),
            "max": float(np.max([f[m] for f in per_frame])),
        }
        for m in metrics
    }


def evaluate_real_vs_sim(real, scene, params, cfg, traj,
                         metrics: Sequence[str] = ("psnr", "ssim"),
                         limit: Optional[int] = None, seed: int = 0,
                         verbose: bool = True) -> Dict:
    """Stamp-synced real-vs-sim evaluation (radar_simulator.cpp:83-96 driven
    by eval_real_to_sim.launch): for each stamped real frame
    (io/realdata.py:RealFrameSequence) render at the trajectory pose of that
    stamp on the scene's device and score the metric suite, logging the
    sync error. Real stamps outside the trajectory are clamped to its ends
    (counted as out_of_traj). The frames' random draws come from one
    torch.Generator(seed) that advances frame by frame; they render
    through the compiled frame (simulate_frame_jit, as the reference's),
    or the eager one for a config it refuses."""
    from radarays_ros_tpu_torch.sim.pipeline import frames_entry

    n = len(real) if limit is None else min(limit, len(real))
    gen = torch.Generator(scene.device).manual_seed(seed)
    simulate_frame = frames_entry(cfg, scene.device, batched=False)
    t_lo, t_hi = float(traj.stamps[0]), float(traj.stamps[-1])

    per_frame = []
    sync_errors = []
    out_of_traj = 0
    for i in range(n):
        stamp = float(real.stamps[i])
        clamped = min(max(stamp, t_lo), t_hi)
        sync_err = clamped - stamp
        if sync_err != 0.0:
            out_of_traj += 1
        pose = torch.from_numpy(traj.pose_at(clamped))
        with torch.no_grad():
            res = simulate_frame(scene, params, cfg, pose, generator=gen)
        sim = res.image_u8.cpu().numpy()
        row = compare_frames(real.frame(i), sim, metrics)
        row["stamp"] = stamp
        row["sync_error_s"] = sync_err
        per_frame.append(row)
        sync_errors.append(sync_err)
        if verbose:
            print(f"frame {i:4d} stamp {stamp:.3f}  "
                  f"sync error: {sync_err * 1e3:.1f} ms  "
                  + "  ".join(f"{m} {row[m]:.3f}" for m in metrics))

    return {"n_frames": n, "per_frame": per_frame,
            "summary": _summary(per_frame, metrics),
            "mode": "real_vs_sim_synced",
            "sync_error_s": {"mean": float(np.mean(np.abs(sync_errors))),
                             "max": float(np.max(np.abs(sync_errors)))},
            "out_of_traj": out_of_traj}


def evaluate_dirs(real_dir, sim_dir,
                  metrics: Sequence[str] = ("psnr", "ssim"),
                  limit: Optional[int] = None) -> Dict:
    """Pairwise evaluation of two frame directories -> summary report."""
    real = load_frame_dir(real_dir)
    sim = load_frame_dir(sim_dir)
    n = min(len(real), len(sim))
    if limit:
        n = min(n, limit)
    per_frame = [compare_frames(real[i], sim[i], metrics) for i in range(n)]
    return {"n_frames": n, "per_frame": per_frame,
            "summary": _summary(per_frame, metrics),
            "real_dir": str(real_dir), "sim_dir": str(sim_dir)}
