"""Asymptotic (Asimov) expected limits: median sensitivity and error bands
with ZERO toy ensembles.

The toy-based :func:`~blueice_tpu.parallel.limits.sensitivity_band` measures
the expected-limit distribution directly; this module computes the same
deliverable from the asymptotic formulae of Cowan, Cranmer, Gross & Vitells
(arXiv:1007.1727, secs. 3.6/3.9): the one-sided q_mu statistic is
asymptotically noncentral-chi2 with noncentrality (mu - mu')^2 / sigma^2, and
sigma comes from the background-only **Asimov dataset** (expected counts at
the null) via ``q_mu(Asimov) = (mu - null)^2 / sigma^2`` (eq. 31). The
+-N-sigma expected upper limits are then

    mu_N = null + sigma(mu_N) * (Phi^-1(1 - alpha) + N)            (eq. 88)

or, with the CLs modification that HistFactory popularized,

    mu_N = null + sigma(mu_N) * (Phi^-1(1 - alpha * Phi(N)) + N)   (eq. 89)

solved self-consistently in mu because sigma varies with the tested
hypothesis. The entire device cost is ONE free fit plus one batched
conditional fit on the Asimov dataset per grid refinement
(:meth:`~blueice_tpu_torch.parallel.toys.BinnedToyStudy.profile_map`) — no
toys. The counterpart of :mod:`blueice_tpu.parallel.asymptotics`.

The reference has no asymptotic-band machinery (its inference layer stops at
Wilks intervals on one dataset, blueice/inference.py:332-389); users pair
this with :func:`sensitivity_band` to cross-check the Gaussian asymptotics
against the exact toy distribution.

Binned studies only: an Asimov *event set* does not exist for unbinned data
(use the toy band there).
"""

from collections import OrderedDict

import numpy as np
from scipy import stats

from ._stats import simulation_truth

__all__ = ['asimov_sigma', 'asimov_expected_limits', 'asimov_median_limit']

_GRID_POINTS = 25
_MAX_ROUNDS = 8


def _require_binned(study):
    if not hasattr(study, 'expected_counts'):
        raise TypeError(
            "Asimov constructions need a binned study (an Asimov event set "
            "does not exist for unbinned data); use the toy-based "
            "sensitivity_band instead")


def _asimov_counts(study, target, truth, null, fixed=None):
    # Parameters held fixed in the fits must shape the Asimov dataset too
    # (explicit truth entries win)
    b_truth = simulation_truth(truth, fixed, **{target: float(null)})
    return study.expected_counts(**b_truth)


def _sigma_on_grid(study, target, hyps, counts, fixed, null):
    """sigma(mu) = (mu - null) / sqrt(q_mu^Asimov) on a hypothesis grid.

    q_mu^A comes from the profile map on the Asimov dataset; the
    best fit there sits at the null (up to numerics), so the two-sided t IS
    the one-sided q_mu on every grid point above the null.
    """
    t, free, _ = study.profile_map([(target, np.asarray(hyps, float))],
                                   counts=counts, fixed=fixed)
    q = np.maximum(np.asarray(t, float).ravel(), 0.0)
    with np.errstate(divide='ignore', invalid='ignore'):
        sigma = (hyps - null) / np.sqrt(q)
    # q -> 0 at mu -> null is a 0/0 with finite limit (the Fisher sigma);
    # grid points too close for float noise get filled from the right
    bad = ~np.isfinite(sigma)
    if bad.all():
        raise ValueError(
            "q_mu on the Asimov dataset is zero over the whole grid "
            "[%g, %g] — the likelihood does not constrain %r there "
            "(is the signal template empty?)" % (hyps[0], hyps[-1], target))
    if bad.any():
        # np.interp clamps to the first/last finite knot, which IS the
        # intended fill for grid points too close to the null for float noise
        sigma = np.interp(hyps, hyps[~bad], sigma[~bad])
    return sigma, float(np.asarray(free[target])[0])


def asimov_sigma(study, target, hypothesis, truth=None, fixed=None, null=0.0):
    """The asymptotic sigma of the target's estimator at one hypothesis,
    from the background-only Asimov dataset (arXiv:1007.1727 eq. 31):
    ``sigma = (hypothesis - null) / sqrt(q_mu^Asimov)``.

    :param truth: background-model parameters of the Asimov dataset (the
      target itself is set to ``null``); default config values.
    :return: float.
    """
    _require_binned(study)
    null = float(null)
    h = float(hypothesis)
    if not h > null:
        raise ValueError("hypothesis (%g) must exceed null (%g)" % (h, null))
    counts = _asimov_counts(study, target, truth, null, fixed)
    sigma, _ = _sigma_on_grid(study, target, np.asarray([h]), counts,
                              fixed, null)
    return float(sigma[0])


def _critical_offsets(cl, quantiles, cls):
    """Per-quantile critical offset c_N such that mu_N = null + sigma * c_N.

    N = Phi^-1(quantile) (so quantile 0.5 is the median, 0.84 the +1 sigma
    edge...); plain q_mu uses eq. 88, the CLs flavor eq. 89.
    """
    alpha = 1.0 - cl
    out = []
    for q in quantiles:
        n = float(stats.norm.ppf(q))
        if cls:
            c = float(stats.norm.ppf(1.0 - alpha * stats.norm.cdf(n))) + n
        else:
            c = float(stats.norm.ppf(1.0 - alpha)) + n
        out.append(c)
    return out


def asimov_expected_limits(study, target, cl=0.9, truth=None, fixed=None,
                           null=0.0, cls=False,
                           quantiles=(0.025, 0.16, 0.5, 0.84, 0.975),
                           n_points=_GRID_POINTS):
    """Median expected upper limit and error band from the Asimov dataset —
    the asymptotic twin of :func:`sensitivity_band`, with no toys at all.

    Solves ``mu_N = null + sigma(mu_N) * c_N`` self-consistently on a
    sigma(mu) curve measured from the profile map on the
    background-only Asimov dataset; the grid re-scales itself until every
    band edge lies inside it.

    :param cls: use the CLs-modified band (eq. 89) instead of the plain
      q_mu one (eq. 88). CLs edges are never below the plain ones — that is
      the prescription's protection near zero sensitivity. Plain-q_mu low
      quantiles whose asymptotic edge lands below the null (strong downward
      fluctuations) clamp to the null, where a bounded parameter's exact
      toy limits pile.
    :param quantiles: band quantiles, matching ``sensitivity_band``'s keys
      (0.5 = median, 0.16/0.84 the +-1 sigma Brazil edges, ...).
    :return: dict with 'band' (OrderedDict quantile -> limit), 'median',
      'sigma' (curve on the final grid), 'hypotheses' (the final grid),
      'x_hat_asimov' (the Asimov free fit — should sit at the null).
    """
    _require_binned(study)
    null = float(null)
    quantiles = sorted(float(q) for q in quantiles)
    offsets = _critical_offsets(float(cl), quantiles, cls)
    c_max = max(offsets)
    if c_max <= 0:
        raise ValueError(
            "every requested quantile maps to a nonpositive critical "
            "offset — raise cl or the quantiles")
    counts = _asimov_counts(study, target, truth, null, fixed)
    bounds = study.compiled.bounds.get(target, (None, None))
    hi_b = None if bounds[1] is None else float(bounds[1])

    # Probe scale: one map call at an arbitrary positive offset (the
    # parameter's own scale if the default is away from the null, else 1)
    probe = abs(float(study.compiled.defaults.get(target, 0.0)) - null)
    probe = probe if probe > 0 else 1.0
    if hi_b is not None:
        if not hi_b > null:
            raise ValueError(
                "the target's upper bound (%g) does not exceed the null "
                "(%g) — no room for an upper limit" % (hi_b, null))
        probe = min(probe, 0.5 * (hi_b - null))
    sigma_p, _ = _sigma_on_grid(study, target, np.asarray([null + probe]),
                                counts, fixed, null)
    hi = null + 3.0 * c_max * float(sigma_p[0])

    for _round in range(_MAX_ROUNDS):
        if hi_b is not None:
            hi = min(hi, hi_b)
        hyps = np.linspace(null, hi, n_points + 1)[1:]
        sigma, x_hat = _sigma_on_grid(study, target, hyps, counts, fixed,
                                      null)

        def solve(c):
            # Fixed point of g(mu) = null + sigma(mu) * c on the measured
            # curve (sigma interpolated, clamped at the grid ends). sigma
            # varies slowly in mu, so plain iteration converges fast.
            if c <= 0:
                # A plain-q_mu low quantile below the null: for a parameter
                # physically bounded at the null the exact toy limits pile
                # just above it, so clamp (the CLs flavor never gets here)
                return null
            mu = null + float(sigma[len(sigma) // 2]) * c
            for _ in range(60):
                s = float(np.interp(mu, hyps, sigma))
                new = null + s * c
                if abs(new - mu) <= 1e-10 * max(1.0, abs(mu)):
                    mu = new
                    break
                mu = 0.5 * (mu + new)   # damped: robust to curve kinks
            # A weakly-constraining model can put the asymptotic edge past
            # the parameter's upper bound, where no exact limit (which pins
            # at the bound) can lie — clamp, like the null clamp above
            if hi_b is not None:
                mu = min(mu, hi_b)
            return mu

        edges = [solve(c) for c in offsets]
        top = max(edges)
        span = hyps[-1] - null
        if top <= hyps[-1] + 1e-9 * span or (hi_b is not None
                                             and hi >= hi_b):
            break
        hi = null + 1.5 * (top - null)

    band = OrderedDict((q, float(e)) for q, e in zip(quantiles, edges))
    return {'band': band, 'median': band.get(0.5),
            'sigma': sigma, 'hypotheses': hyps, 'x_hat_asimov': x_hat}


def asimov_median_limit(study, target, cl=0.9, truth=None, fixed=None,
                        null=0.0, cls=False):
    """Median expected upper limit (the Brazil-band center line) from the
    Asimov dataset — :func:`asimov_expected_limits` at the 0.5 quantile."""
    out = asimov_expected_limits(study, target, cl=cl, truth=truth,
                                 fixed=fixed, null=null, cls=cls,
                                 quantiles=(0.5,))
    return out['band'][0.5]
