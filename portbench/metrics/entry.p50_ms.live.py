"""entry.p50_ms.live: the median frame latency, from the call into the
entry to its u8 image on the host, over the window's untraced calls
(ms)."""

import numpy as np


def read(run):
    s = run.window.latency_s[run.window.traced_calls:]
    return float(np.median(s)) * 1e3 if s else None
