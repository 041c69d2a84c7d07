"""fit_evals_per_s: the objective evaluations of every fit completed in the
window (a gradient step is one evaluation with its gradient), over the
window's seconds (host clock)."""


def read(run):
    return run.window.evals / run.window.seconds if run.window.evals \
        else None
