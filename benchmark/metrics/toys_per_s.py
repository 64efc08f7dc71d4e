"""toys_per_s: toys whose statistic t was completed in the window, over the
window's seconds (from the first call's start to the synchronised end of the
last call begun before ``--seconds`` had passed)."""


def read(run):
    return run.completed / run.window_s if run.window_s > 0 else None
