"""Shared statistics helpers for the toolkit modules (cls / discovery /
gof / limits / coverage): the simulation-truth convention for calibration
ensembles and the add-one-smoothed tail-fraction estimator. One
implementation each — these conventions must not drift between modules.
"""

import numpy as np

__all__ = ['simulation_truth', 'tail_fraction']


def simulation_truth(truth, fixed, **overrides):
    """Simulation parameters for a calibration ensemble.

    ``fixed=`` asserts parameter values for every fit; an ensemble
    calibrated under that assertion must be SIMULATED there too, or the toy
    statistics belong to a different model than the fits (fixed at 2.0 in
    the fits, simulated at the config default 1.0). Explicit ``truth``
    entries win over ``fixed`` (a user may deliberately simulate off the
    fixed point, e.g. for robustness studies), and keyword overrides (the
    target's per-ensemble value) win over both.
    """
    out = dict(fixed or {})
    out.update(truth or {})
    out.update(overrides)
    return out


def tail_fraction(sorted_sample, q_obs):
    """Add-one-smoothed P(X >= q_obs) from a SORTED calibration sample,
    vectorized over ``q_obs`` of any shape.

    Add-one smoothing keeps p strictly positive (an observed statistic above
    every calibration toy is evidence, not p = 0) and is the standard
    unbiased permutation-test estimator. The threshold carries a relative
    AND an absolute float tolerance so a calibration toy equal to the
    observed statistic up to float noise counts as >= (the absolute term
    matters at q_obs ~ 0, where every nonnegative statistic must tie, and
    for GOF statistics that can go slightly negative under priors).
    """
    sorted_sample = np.asarray(sorted_sample, dtype=float)
    n = sorted_sample.shape[-1]
    thresh = np.asarray(q_obs, dtype=float) * (1.0 - 1e-12) - 1e-12
    # searchsorted('left') counts strictly-less entries; the rest are >=
    idx = np.searchsorted(sorted_sample, thresh, side='left')
    return (1.0 + (n - idx)) / (1.0 + n)
