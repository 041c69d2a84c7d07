"""frames_per_s: every frame whose u8 image reached the host in the window,
over the window's seconds (host clock)."""


def read(run):
    return run.window.frames / run.window.seconds if run.window.frames \
        else None
