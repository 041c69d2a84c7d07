"""fit.host_ms_per_eval: the median, over consecutive evaluations i, i+1
inside one `rr.fit.run` span of the traced fits, where evaluation i+1
holds an `rr.graph.replay` span, of the time from the end of
`rr.fit.eval` i to the end of that replay (ms, the profiler's clock):
Adam's step, the loop's bookkeeping, the black box's search, the
argument copy-in and the graph's launch, which the card waits for between
two evaluations. None where the trace holds no such pair (a program
without these spans)."""

import numpy as np


def _spans(t, name):
    return sorted((s, e) for n, s, e in t.host if n == name)


def read(run):
    t = run.trace
    if t is None:
        return None
    evals, replays = _spans(t, "rr.fit.eval"), _spans(t, "rr.graph.replay")
    out = []
    for r0, r1 in _spans(t, "rr.fit.run"):
        ev = [(s, e) for s, e in evals if s >= r0 and e <= r1]
        for (_, e0), (s1, e1) in zip(ev, ev[1:]):
            ends = [re for rs, re in replays if rs >= s1 and re <= e1]
            if ends:
                out.append(min(ends) - e0)
    return float(np.median(out)) / 1e3 if out else None
