"""device.idle_pct.<cell kind>: the device's idle share of the traced
window (%), 100 * (1 - the union of the device events' time ranges / the
window's length). One reader for every such metric (.stream, .live,
.fit), each of which moves its own cells' end-to-end metric."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    b = t.busy_s()
    return 100.0 * (1.0 - b / t.window_s) if b else None
