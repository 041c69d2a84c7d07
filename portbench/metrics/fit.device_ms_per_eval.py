"""fit.device_ms_per_eval: the device's busy time in the traced fits (the
union of the device events), per objective evaluation (ms)."""


def read(run):
    t = run.trace
    if t is None or not t.evals:
        return None
    b = t.busy_s()
    return b * 1e3 / t.evals if b else None
