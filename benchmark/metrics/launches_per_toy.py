"""launches_per_toy: the device kernels of the traced window (the harness's
own left out) over the window's toys."""


def read(run):
    rec = run.trace
    if rec is None or rec.toys == 0:
        return None
    n = len(rec.kernels())
    return n / rec.toys if n else None
