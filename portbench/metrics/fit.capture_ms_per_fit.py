"""fit.capture_ms_per_fit: the summed duration of the `rr.graph.build`
spans (static buffers, eager warm-up, capture) inside the traced
`rr.fit.run` spans, over the number of those fits (ms, the profiler's
clock). None where the trace holds no `rr.fit.run` span (a program
without these spans)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    fits = [(s, e) for n, s, e in t.host if n == "rr.fit.run"]
    if not fits:
        return None
    built = sum(e - s for n, s, e in t.host if n == "rr.graph.build"
                and any(f0 <= s and e <= f1 for f0, f1 in fits))
    return built / 1e3 / len(fits)
