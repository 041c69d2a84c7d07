"""frame_p95_ms: the 95th percentile (linear interpolation) of every
frame's latency in the window, from the call into the entry to its u8
image on the host (host clock); one frame a call."""

import numpy as np


def read(run):
    lat = run.window.latency_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
