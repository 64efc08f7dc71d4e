"""Faults planted in the timed path, to show that the check fails them
(``benchmark/tests/test_bench_faults.py`` on the CPU, ``calibrate.py
--faults`` on the card). Each takes the study and breaks it in place."""

import numpy as np

__all__ = ['FAULTS']


def _toys(data):
    """The tensors of a call's datasets, each with the toys first: the
    tensor itself, or the tensors of a tuple (an event set)."""
    return tuple(data) if isinstance(data, (tuple, list)) else (data,)


def _head(data, n):
    """The first ``n`` toys of a call's datasets."""
    head = tuple(v[:n] for v in _toys(data))
    return head if isinstance(data, (tuple, list)) else head[0]


def start_unchanged(study):
    """No Newton step and no polish: each fit returns its start point."""
    study.max_iter = 0
    study.polish = 0


def half_start_unchanged(study):
    """Every other toy's fits return their start point (the program's own
    results with no step taken), the rest are fitted as they should be."""
    orig = study._run_profile
    unfitted = ({}, {})     # the fitters built with no step, cached apart

    def half(data, target, hypothesis, fixed, mesh=None):
        t, free, cond = orig(data, target, hypothesis, fixed)
        kept = (study.max_iter, study.polish, study._profile_cache,
                study._fit_cache)
        study.max_iter, study.polish = 0, 0
        study._profile_cache, study._fit_cache = unfitted
        try:
            t0, free0, cond0 = orig(data, target, hypothesis, fixed)
        finally:
            (study.max_iter, study.polish, study._profile_cache,
             study._fit_cache) = kept
        odd = np.arange(len(t)) % 2 == 1
        for r, r0 in ((free, free0), (cond, cond0)):
            r.x = np.where(odd[:, None], r0.x, r.x)
            r.max_ll = np.where(odd, r0.max_ll, r.max_ll)
            r.n_iter = np.where(odd, r0.n_iter, r.n_iter)
        return np.where(odd, t0, t), free, cond
    study._run_profile = half


def half_left_out(study):
    """Half of the batch fitted, its results standing in for the rest."""
    orig = study._run_profile

    def half(data, target, hypothesis, fixed, mesh=None):
        n = _toys(data)[0].shape[0]
        t, free, cond = orig(_head(data, n // 2), target, hypothesis, fixed)
        for r in (free, cond):
            r.x = np.concatenate([r.x, r.x])[:n]
            r.max_ll = np.concatenate([r.max_ll, r.max_ll])[:n]
            r.n_iter = np.concatenate([r.n_iter, r.n_iter])[:n]
        return np.concatenate([t, t])[:n], free, cond
    study._run_profile = half


def answer_altered(study):
    """t altered where it is produced."""
    orig = study._run_profile

    def altered(*args, **kw):
        t, free, cond = orig(*args, **kw)
        return t + 0.5, free, cond
    study._run_profile = altered


#: The faults by name
FAULTS = {f.__name__: f for f in (start_unchanged, half_start_unchanged,
                                   half_left_out, answer_altered)}
