"""setup_s: from the start of the run's process to the window: imports,
the card's context, the scene, the host build, the upload, the targets and
the warm-up (the first run of a checkout also compiles)."""


def read(run):
    return run.setup_s
