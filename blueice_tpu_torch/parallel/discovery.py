"""Discovery significance on the compiled profile-likelihood engines.

The reference stops at interval setting (blueice/inference.py:332-389) and
leaves discovery tests — "is the signal rate nonzero?" — to the user, who
assembles them by hand from bestfit calls. This module supplies the standard
machinery (Cowan, Cranmer, Gross, Vitells, arXiv:1007.1727) on the same
batched double fits that power limit setting:

- :func:`discovery_ts`: the one-sided discovery statistic
  ``q0 = 2(LL(x_hat) - LL(target=null)) if x_hat > null else 0``
  for every toy of a batched ensemble (one batched double fit).
- :func:`observed_discovery`: observed q0 on one dataset, with the
  asymptotic p-value/Z (half-chi2 null) and, optionally, a toy-calibrated
  p-value from a null-hypothesis ensemble run on the same fitters.
- :func:`asimov_discovery`: the median expected significance from the
  Asimov dataset (expected counts at the signal truth), binned studies.

The counterpart of :mod:`blueice_tpu.parallel.discovery`. All functions
take a ``BinnedToyStudy`` or ``UnbinnedToyStudy``
(:mod:`blueice_tpu_torch.parallel.toys`); ``asimov_discovery`` is binned-only
(an Asimov *event set* does not exist for unbinned data — use the median of
:func:`discovery_ts` under the signal truth instead).
"""

import numpy as np
import torch
from scipy import stats

from ._stats import simulation_truth, tail_fraction
from .fitter import tree_map

__all__ = ['discovery_ts', 'observed_discovery', 'asimov_discovery',
           'discovery_reach']


def _check_target_free(target, fixed):
    if target in (fixed or {}):
        raise ValueError(
            "the discovery target %r cannot also be in fixed= — the free "
            "fit must float it" % target)


def _one_sided(t, x_hat, null):
    """Mask the two-sided profile-LR statistic to the discovery convention:
    a downward fluctuation (best fit at or below the null) is no evidence
    FOR a signal, so q0 = 0 there. For a target bounded below at the null
    (the usual [0, inf) rate multiplier) this is a no-op — the bounded best
    fit pins to the null and t is already 0 — but for ``allow_negative``
    targets it is what makes q0 one-sided."""
    return np.where(np.asarray(x_hat) > null, np.asarray(t), 0.0)


def discovery_ts(study, seed_or_generator, n_toys, target, truth=None,
                 fixed=None, mesh=None, null=0.0):
    """Per-toy discovery statistic q0 over a batched toy ensemble.

    Simulates ``n_toys`` datasets at ``truth`` and computes
    ``q0 = 2(LL_free - LL(target=null))``, zeroed for toys whose best fit
    lands at or below ``null`` (one-sided convention). With
    ``truth[target] = null`` this is the null-calibration ensemble (q0's
    sampling distribution under background-only, asymptotically a half-chi2
    with a point mass at 0); with the signal truth it is the expected
    discovery-significance distribution.

    ``fixed`` values are folded into the simulation truth (explicit
    ``truth`` entries win): fixing a parameter in the fits asserts its
    value, so the calibration ensemble must be simulated there too.

    :return: (q0 array (n_toys,), free ToyResults, conditional ToyResults).
    """
    _check_target_free(target, fixed)
    truth = simulation_truth(truth, fixed)
    t, free, cond = study.profile_ts(seed_or_generator, n_toys, target,
                                     float(null),
                                     truth=truth, fixed=fixed, mesh=mesh)
    return _one_sided(t, free[target], float(null)), free, cond


def _significance(q0):
    """Asymptotic (p, Z) of an observed q0: Z = sqrt(q0), p = 1 - Phi(Z)."""
    z = float(np.sqrt(max(q0, 0.0)))
    return float(stats.norm.sf(z)), z


def observed_discovery(study, target, counts=None, fixed=None, null=0.0,
                       seed_or_generator=None, n_calibration=0, truth=None,
                       mesh=None):
    """Observed discovery test on ONE dataset.

    Computes the observed ``q0`` via the profile map (one free fit + one
    conditional fit at ``target=null``), the asymptotic p-value and
    significance ``Z = sqrt(q0)``, and — when ``seed_or_generator`` and
    ``n_calibration`` are given — a toy-calibrated p-value: the
    add-one-smoothed fraction of a null-hypothesis ensemble (``truth`` with
    ``target=null``) whose q0 reaches the observed one. Toy calibration
    reuses the ensemble's double fit, so its cost is one toy study.

    :param counts: observed count tensor(s) (binned studies only); default
      is the likelihood's ``set_data`` dataset for either study type.
    :return: dict with ``q0``, ``x_hat``, ``p_asymptotic``, ``Z_asymptotic``
      and, when calibrated, ``p_toys``, ``Z_toys``, ``q0_calibration``.
    """
    _check_target_free(target, fixed)
    null = float(null)
    kwargs = {'fixed': fixed}
    if counts is not None:
        if not hasattr(study, 'observed_counts'):
            raise ValueError(
                "counts= applies to binned studies; unbinned observed data "
                "is bound with lf.set_data")
        kwargs['counts'] = counts
    t, free, _ = study.profile_map([(target, np.asarray([null]))], **kwargs)
    x_hat = float(np.asarray(free[target])[0])
    q0 = float(_one_sided(np.asarray(t).ravel(), [x_hat], null)[0])
    p, z = _significance(q0)
    out = {'q0': q0, 'x_hat': x_hat, 'p_asymptotic': p, 'Z_asymptotic': z}

    if n_calibration:
        if seed_or_generator is None:
            raise ValueError("toy calibration needs seed_or_generator= for "
                             "the ensemble")
        null_truth = simulation_truth(truth, fixed, **{target: null})
        q0_toys, _, _ = discovery_ts(study, seed_or_generator,
                                     int(n_calibration), target,
                                     truth=null_truth, fixed=fixed,
                                     mesh=mesh, null=null)
        p_toys = float(tail_fraction(np.sort(q0_toys), q0))
        out['p_toys'] = float(p_toys)
        out['Z_toys'] = float(stats.norm.isf(p_toys))
        out['q0_calibration'] = q0_toys
    return out


def asimov_discovery(study, target, truth, fixed=None, null=0.0):
    """Median expected discovery significance from the Asimov dataset.

    The Asimov dataset of a binned likelihood is the expected count in every
    bin at the signal ``truth`` (non-integer counts are fine — the Poisson
    term is gammaln-based). Its q0 gives the median significance of the
    signal+background ensemble directly: ``Z_A = sqrt(q0_A)``
    (arXiv:1007.1727 eq. 97), with no toy ensemble at all.

    :param truth: parameter dict INCLUDING the signal (e.g.
      ``{target: 1.0}``); a truth at the null gives Z_A = 0.
    :return: dict with ``q0_asimov``, ``Z_asimov``, ``x_hat`` (the free fit
      on the Asimov dataset — should reproduce ``truth[target]``).
    """
    if not hasattr(study, 'expected_counts'):
        raise TypeError(
            "asimov_discovery needs a binned study (an Asimov event set "
            "does not exist for unbinned data); use the median of "
            "discovery_ts under the signal truth instead")
    _check_target_free(target, fixed)
    counts = study.expected_counts(**simulation_truth(truth, fixed))
    res = observed_discovery(study, target, counts=counts, fixed=fixed,
                             null=null)
    return {'q0_asimov': res['q0'], 'Z_asimov': res['Z_asymptotic'],
            'x_hat': res['x_hat']}


def discovery_reach(study, target, signal_values, truth=None, fixed=None,
                    null=0.0, z_thresholds=(3.0, 5.0)):
    """Median expected significance vs signal strength, and the smallest
    signal reaching each Z threshold — the discovery-reach curve of a
    sensitivity study, from Asimov datasets with zero toy ensembles.

    Fully batched: the Asimov datasets of ALL signal values are lanes of the
    same two fitters (one free, one with the target fixed at the null) that
    toy ensembles use — S grid points cost two batched fits, not S interval
    loops.

    :param signal_values: grid of ``target`` truths (ascending recommended;
      the reach interpolation sorts internally).
    :param truth: background-model parameters of the Asimov datasets.
    :param z_thresholds: significances whose crossings to report (default
      the conventional evidence/discovery 3 and 5 sigma).
    :return: dict with 'signal_values', 'q0', 'Z' (= sqrt(q0), the Asimov
      median expected significance per grid point, arXiv:1007.1727 eq. 97),
      'x_hat' (free fits — should reproduce the signal values), and 'reach'
      ({threshold: smallest signal with Z >= threshold, linearly
      interpolated; NaN if not reached inside the grid}).
    """
    if not hasattr(study, 'expected_counts'):
        raise TypeError(
            "discovery_reach needs a binned study (an Asimov event set does "
            "not exist for unbinned data); use discovery_ts medians under "
            "each signal truth instead")
    _check_target_free(target, fixed)
    null = float(null)
    svals = np.sort(np.atleast_1d(np.asarray(signal_values, dtype=float)))
    if len(svals) < 2:
        raise ValueError("signal_values must be a grid of >= 2 values")
    base = simulation_truth(truth, fixed)
    counts = []
    for s in svals:
        t = dict(base)
        t[target] = float(s)
        counts.append(study.expected_counts(**t))
    stacked = tree_map(lambda *cs: torch.stack(cs), *counts)
    free = study.fit_toys(stacked, fixed=fixed)
    cond_fixed = dict(fixed or {})
    cond_fixed[target] = null
    cond = study.fit_toys(stacked, fixed=cond_fixed)
    q0 = np.maximum(
        2.0 * (np.asarray(free.max_ll) - np.asarray(cond.max_ll)), 0.0)
    q0 = _one_sided(q0, free[target], null)
    z = np.sqrt(q0)
    reach = {}
    for zt in z_thresholds:
        zt = float(zt)
        above = z >= zt
        if above[0]:
            reach[zt] = float(svals[0])
        elif not above.any():
            reach[zt] = float('nan')
        else:
            j = int(np.argmax(above))
            w = (zt - z[j - 1]) / (z[j] - z[j - 1])
            reach[zt] = float(svals[j - 1] + w * (svals[j] - svals[j - 1]))
    return {'signal_values': svals, 'q0': q0, 'Z': z,
            'x_hat': np.asarray(free[target]), 'reach': reach}
