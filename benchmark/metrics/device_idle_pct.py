"""device_idle_pct: the share of the traced window in which no operation ran
on the card (the harness's own bookkeeping left out), from the profiler's
timeline."""


def read(run):
    rec = run.trace
    if rec is None or rec.window_s <= 0 or rec.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
