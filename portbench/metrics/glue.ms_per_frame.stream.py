"""glue.ms_per_frame.stream: device time of every kernel that is none of
the port's hand-written kernels (K1-K5 and the lookup's backward), in the
traced calls, per frame (ms): the frame's PyTorch ops on the card."""

from portbench.frozen import group_name
from portbench.tracing import HANDWRITTEN


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    s = sum(e - b for n, b, e in t.kernels()
            if group_name(n) not in HANDWRITTEN) / 1e6
    return s * 1e3 / t.frames if s else None
