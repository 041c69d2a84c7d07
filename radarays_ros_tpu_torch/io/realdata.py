"""Real radar frame sequences: stamped polar-image ingest (counterpart of
radarays_ros_tpu/io/realdata.py; NumPy).

The reference validates against real Navtech frames by replaying a bag and
simulating at each incoming stamp (sync_topic mode,
radar_simulator.cpp:83-96; launch/tests/eval_real_to_sim.launch:10-17).
Offline, that data is a directory of polar frames with timestamps, e.g. the
MulRan dataset's `sensor_data/radar/polar/<epoch_ns>.png` export.

Stamp sources, in priority order:
  1. a stamps file (`stamps.txt` beside the frames, or a given path): one
     stamp per line, or `<filename> <stamp>` pairs; `#` comments;
  2. numeric file stems (values > 1e14 read as ns, > 1e10 as ms, else s);
  3. frame index / `rate`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_FRAME_SUFFIXES = (".png", ".npy")


def _stamp_from_name(stem: str) -> Optional[float]:
    try:
        v = float(stem)
    except ValueError:
        return None
    if v > 1e14:          # nanoseconds since epoch (MulRan)
        return v * 1e-9
    if v > 1e10:          # milliseconds
        return v * 1e-3
    return v


class RealFrameSequence:
    """A directory of stamped real polar frames (.png grayscale or .npy),
    loaded lazily; stamps are sorted seconds (float64). `transpose=True`
    reads frames stored as (azimuth, range) rows."""

    def __init__(self, directory, stamps_file=None, rate: float = 4.0,
                 transpose: bool = False):
        self.dir = Path(directory)
        self.transpose = transpose
        paths = sorted(p for p in self.dir.iterdir()
                       if p.suffix.lower() in _FRAME_SUFFIXES)
        if not paths:
            raise ValueError(f"no frames (.png/.npy) in {self.dir}")

        stamps = None
        sf = Path(stamps_file) if stamps_file else self.dir / "stamps.txt"
        if sf.exists():
            by_name = {}
            listed = []
            for line in sf.read_text().splitlines():
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    by_name[parts[0]] = float(parts[1])
                else:
                    listed.append(float(parts[0]))
            if by_name:
                paths = [p for p in paths if p.name in by_name]
                stamps = np.array([by_name[p.name] for p in paths])
            elif listed:
                if len(listed) < len(paths):
                    raise ValueError(
                        f"{sf}: {len(listed)} stamps for {len(paths)} frames")
                stamps = np.array(listed[: len(paths)])
        if stamps is None:
            named = [_stamp_from_name(p.stem) for p in paths]
            if all(s is not None for s in named):
                stamps = np.array(named, np.float64)
            else:
                stamps = np.arange(len(paths), dtype=np.float64) / rate

        order = np.argsort(stamps, kind="stable")
        self.paths: List[Path] = [paths[i] for i in order]
        self.stamps: np.ndarray = np.asarray(stamps, np.float64)[order]

    def __len__(self) -> int:
        return len(self.paths)

    def frame(self, i: int) -> np.ndarray:
        p = self.paths[i]
        if p.suffix.lower() == ".npy":
            img = np.load(p)
        else:
            from radarays_ros_tpu_torch.io.image_io import read_png_gray

            img = read_png_gray(p)
        return img.T if self.transpose else img

    def nearest(self, stamp: float) -> Tuple[int, float]:
        """Index of the stamp-nearest frame + signed sync error [s]
        (frame_stamp - requested), as the reference logs it
        (radar_simulator.cpp:94)."""
        i = int(np.searchsorted(self.stamps, stamp))
        cands = [j for j in (i - 1, i) if 0 <= j < len(self.stamps)]
        j = min(cands, key=lambda k: abs(self.stamps[k] - stamp))
        return j, float(self.stamps[j] - stamp)
