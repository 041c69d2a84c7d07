"""entry.host_ms.live: the median host time inside the call into the
entry (inputs copied in, the graph's replay enqueued), over the window's
untraced calls (ms; the benchmark's span around the call)."""

import numpy as np


def read(run):
    s = run.window.host_s[run.window.traced_calls:]
    return float(np.median(s)) * 1e3 if s else None
