"""frame.launches_per_frame.stream: device kernels the profiler saw in the
traced calls, per frame (copies and sets not counted)."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    n = len(t.kernels())
    return n / t.frames if n else None
