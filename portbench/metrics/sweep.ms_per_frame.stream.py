"""sweep.ms_per_frame.stream: device time of K1 (the port's sweep_kernel)
in the traced calls, per frame (ms)."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    s = t.group_s().get("sweep_kernel", 0.0)
    return s * 1e3 / t.frames if s else None
