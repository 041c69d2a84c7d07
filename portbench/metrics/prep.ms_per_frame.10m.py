"""prep.ms_per_frame.10m: device time of the hierarchical culling prep, K2
and K3 (the port's prep_hier_kernel and coarse_words_kernel), in the
traced calls of the 10M-triangle cell, per frame (ms): the part of the
trace whose work the prep group sets (its supergroup boxes)."""

PREP = ("prep_hier_kernel", "coarse_words_kernel")


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    g = t.group_s()
    s = sum(g.get(k, 0.0) for k in PREP)
    return s * 1e3 / t.frames if s else None
