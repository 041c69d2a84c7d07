"""entry.to_launch_ms.live: the median, over the traced calls, of the time
from the start of the port's outermost `rr.frame.entry` span to the end of
the last `rr.graph.replay` span inside it (ms, the profiler's clock): the
host's work in the compiled entry (draws, arguments, key, copy-in, launch)
before the frame's device work is all enqueued. None where the trace holds
no entry with a replay in it (a program without these spans)."""

import numpy as np


def read(run):
    t = run.trace
    if t is None:
        return None
    entries = sorted((s, e) for n, s, e in t.host if n == "rr.frame.entry")
    replays = [(s, e) for n, s, e in t.host if n == "rr.graph.replay"]
    out, outer_end = [], -np.inf
    for s, e in entries:
        if s < outer_end:           # inside an entry already read
            continue
        outer_end = e
        ends = [re for rs, re in replays if rs >= s and re <= e]
        if ends:
            out.append(max(ends) - s)
    return float(np.median(out)) / 1e3 if out else None
