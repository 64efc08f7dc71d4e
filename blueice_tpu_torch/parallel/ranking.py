"""Nuisance-parameter pulls, constraints and impact ranking on the observed
dataset — the "ranking plot" deliverable of modern inference stacks, as
batched fits on the study's device (the counterpart of
:mod:`blueice_tpu.parallel.ranking`).

For each nuisance theta (every registered fit parameter except the parameter
of interest and anything held fixed):

* **post-fit value and error**: theta_hat and the profile (minos-style)
  +-1 sigma interval from the t = 1 crossings of the profile-LR
  curve (:func:`~blueice_tpu_torch.parallel.limits.observed_interval` with
  ``kind='central'`` at the 68.27% level);
* **pull** ``(theta_hat - mu_prior)/sigma_prior`` and **constraint**
  ``sigma_postfit/sigma_prior`` for nuisances carrying a Gaussian prior
  (``add_rate_uncertainty``/``add_shape_uncertainty``);
* **post-fit impact**: Delta mu when theta is fixed at theta_hat +-
  sigma_postfit and everything else is re-profiled — both lanes of ONE
  batched conditional-fit call (:meth:`profile_map`);
* **pre-fit impact**: same with theta_hat +- sigma_prior (Gaussian-prior
  nuisances only), values clamped into the parameter's bounds.

The reference has no ranking machinery at all — its users hand-assemble
per-nuisance ``bestfit_scipy(**{theta: v})`` loops (each a full scipy
minimization, reference blueice/inference.py:131-178). Here every number
comes from batched calls of two fitters per nuisance (the adaptive interval
scan and a few two-lane impact calls), warm-started from one shared free
fit.
"""

import warnings
from collections import OrderedDict

import numpy as np

from ..priors import NormalPrior
from .limits import observed_interval

__all__ = ['nuisance_ranking']


def _gaussian_prior(lf, name):
    """(mu, sigma) of ``name``'s prior if it is a Gaussian one, else None."""
    if name.endswith('_rate_multiplier'):
        lp = lf.rate_parameters.get(name[:-len('_rate_multiplier')])
    else:
        entry = lf.shape_parameters.get(name)
        lp = entry[1] if entry is not None else None
    if isinstance(lp, NormalPrior):
        return lp.mu, lp.sigma
    return None


def _registered_params(lf):
    names = [s + '_rate_multiplier' for s in lf.rate_parameters]
    names += list(lf.shape_parameters.keys())
    return names


def _clamp_to_bounds(values, bounds):
    lo, hi = bounds
    v = np.asarray(values, dtype=float)
    if lo is not None:
        v = np.maximum(v, lo)
    if hi is not None:
        v = np.minimum(v, hi)
    return v


def _impact(study, name, at_values, target, mu_hat, map_kwargs):
    """Delta mu for theta=name fixed at each of ``at_values`` (re-profiling
    everything else): lanes of one batched conditional-fit call. NaN lanes
    (an unresolved interval edge) are skipped without a device call."""
    at = np.asarray(at_values, dtype=float)
    ok = np.isfinite(at)
    out = np.full(at.shape, np.nan)
    if ok.any():
        _, _, cond = study.profile_map([(name, at[ok])], **map_kwargs)
        out[ok] = np.asarray(cond[target], dtype=float) - mu_hat
    return out


def nuisance_ranking(study, target, counts=None, fixed=None, cl=0.6827,
                     prefit=True):
    """Pulls, constraints and impacts of every nuisance on the observed
    dataset, ranked by post-fit impact on ``target``.

    :param study: a BinnedToyStudy or UnbinnedToyStudy (prepared likelihood;
      data bound with ``set_data`` unless binned ``counts=`` are given).
    :param target: the parameter of interest.
    :param counts: observed count tensor(s) (binned studies only); default
      the ``set_data`` dataset.
    :param fixed: extra parameters held fixed everywhere (excluded from the
      ranking).
    :param cl: level of the post-fit profile interval (default 68.27%,
      the +-1 sigma convention).
    :param prefit: also compute pre-fit impacts for Gaussian-prior nuisances.
    :return: dict with 'target', 'target_hat', 'target_interval' (the POI's
      own profile interval at ``cl``), and 'nuisances' — a list (sorted by
      descending ``max(|impact_lo|, |impact_hi|)``) of OrderedDicts with
      keys name, theta_hat, sigma_lo, sigma_hi (profile errors), pull,
      constraint, prior_mu, prior_sigma (None without a Gaussian prior),
      impact_lo, impact_hi (Delta mu at theta_hat -+ sigma), and
      prefit_impact_lo/hi (None unless a Gaussian prior and ``prefit``).
    """
    fixed = dict(fixed or {})
    lf = study.lf
    names = [n for n in _registered_params(lf)
             if n != target and n not in fixed]
    if target not in _registered_params(lf):
        raise ValueError("unknown target %r (registered: %s)"
                         % (target, _registered_params(lf)))
    map_kwargs = {'fixed': fixed}
    interval_kwargs = {'fixed': fixed}
    if counts is not None:
        if not hasattr(study, 'observed_counts'):
            raise ValueError(
                "counts= applies to binned studies; unbinned observed data "
                "is bound with lf.set_data")
        counts = study.observed_counts(counts)
        map_kwargs['counts'] = counts
        interval_kwargs['counts'] = counts

    # The POI's own fit and profile interval (shares the free fitter with
    # every per-nuisance scan below)
    (mu_lo, mu_hi), _, _, free = observed_interval(
        study, target, kind='central', cl=cl, return_grid=True,
        **interval_kwargs)
    mu_hat = float(np.asarray(free[target])[0])

    rows = []
    for name in names:
        (lo, hi), _, _, fr = observed_interval(
            study, name, kind='central', cl=cl, return_grid=True,
            **interval_kwargs)
        th = float(np.asarray(fr[name])[0])
        sigma_lo = th - lo if np.isfinite(lo) else np.nan
        sigma_hi = hi - th if np.isfinite(hi) else np.nan
        if not (np.isfinite(lo) and np.isfinite(hi)):
            warnings.warn(
                "the %s profile interval did not fully resolve (the curve "
                "may be flat inside the bounds); its impact on that side "
                "is NaN" % name)
        # Post-fit impact: theta fixed at its interval edges. Down-shifting
        # theta conventionally pairs with 'impact_lo'
        d = _impact(study, name, [lo, hi], target, mu_hat, map_kwargs)
        prior = _gaussian_prior(lf, name)
        row = OrderedDict(
            name=name, theta_hat=th, sigma_lo=sigma_lo, sigma_hi=sigma_hi,
            pull=None, constraint=None, prior_mu=None, prior_sigma=None,
            impact_lo=float(d[0]), impact_hi=float(d[1]),
            prefit_impact_lo=None, prefit_impact_hi=None)
        if prior is not None:
            mu0, sp = prior
            row['prior_mu'], row['prior_sigma'] = mu0, sp
            row['pull'] = (th - mu0) / sp
            if np.isfinite(sigma_lo) and np.isfinite(sigma_hi):
                row['constraint'] = 0.5 * (sigma_lo + sigma_hi) / sp
            if prefit:
                at = _clamp_to_bounds(
                    [th - sp, th + sp],
                    study.compiled.bounds.get(name, (None, None)))
                dp = _impact(study, name, at, target, mu_hat, map_kwargs)
                row['prefit_impact_lo'] = float(dp[0])
                row['prefit_impact_hi'] = float(dp[1])
        rows.append(row)

    def _rank(r):
        vals = [abs(v) for v in (r['impact_lo'], r['impact_hi'])
                if np.isfinite(v)]
        return max(vals) if vals else -np.inf
    rows.sort(key=_rank, reverse=True)
    return {'target': target, 'target_hat': mu_hat,
            'target_interval': (mu_lo, mu_hi), 'nuisances': rows}
