"""iters_per_fit: the mean of the Newton iterations (``ToyResults.n_iter``)
over the traced window's free and conditional fits."""

import numpy as np


def read(run):
    if run.trace is None or len(run.n_iter) == 0:
        return None
    return float(np.mean(run.n_iter))
