"""Goodness-of-fit for binned likelihoods: the saturated-model ratio.

The standard binned GOF statistic is t = 2(LL_saturated - LL_bestfit), the
likelihood ratio against the saturated model (one free expectation per bin,
which reproduces the data exactly — Baker & Cousins, Nucl.Instrum.Meth. 221
(1984) 437). The reference provides no GOF machinery (users hand-roll it over
``bestfit_*`` calls); here the best fit is one lane of the batched fitter
and the calibration ensemble is a parametric bootstrap at the observed best
fit, so the whole test is two batched fits of the fitter a toy study
already has.

The p-value is toy-calibrated by default and by design: the chi-squared
(n_bins - n_free) asymptotic is unreliable at low bin counts and is further
shifted by any prior/constraint terms in the likelihood (they enter
LL_bestfit but not LL_saturated). The bootstrap sidesteps both.

The counterpart of :mod:`blueice_tpu.parallel.gof`. A compiled
LogLikelihoodSum's dataset is a tuple, one count tensor per child; its
saturated model carries the sum's weights.
"""

import numpy as np
import torch
from scipy import special

from ._stats import simulation_truth, tail_fraction
from .fitter import tree_map

__all__ = ['saturated_logl', 'gof_ts', 'gof_pvalue']


def _sat_terms(k, axes):
    """Per-toy saturated LL: sum over ``axes`` of xlogy(k,k) - k -
    gammaln(k+1) (the Poisson log pmf at mu = k; zero-count bins contribute
    0)."""
    k = np.asarray(k, dtype=float)
    return np.sum(special.xlogy(k, k) - k - special.gammaln(k + 1.0),
                  axis=axes)


def saturated_logl(study, counts, batched=False):
    """Saturated-model log likelihood of a dataset (or a batch of them),
    matching the compiled likelihood's data conventions, including the
    per-child likelihood weights of a compiled LogLikelihoodSum.

    :param counts: count tensor(s) (or arrays) shaped like
      ``study.expected_counts()``, with a leading toy axis when ``batched``.
    :return: float, or (n_toys,) array when ``batched``.
    """
    def sat(c):
        k = np.asarray(c.cpu().numpy() if torch.is_tensor(c) else c,
                       dtype=float)
        return _sat_terms(k, tuple(range(1, k.ndim)) if batched else None)
    children = getattr(study.compiled, 'children', None)
    if children is None:
        return sat(counts)
    out = 0.0
    for w, c, ci in zip(study.compiled.child_weights, children, counts):
        if c.has_data:
            out = out + w * sat(ci)
    return out


def gof_ts(study, counts=None, fixed=None):
    """Observed saturated-ratio GOF statistic on ONE dataset.

    t = 2(LL_saturated - LL_bestfit). With prior/constraint terms in the
    likelihood, t is shifted by -2*prior(theta_hat) relative to the pure
    Poisson ratio (and can even go slightly negative for priors whose log
    density is positive at the fit) — compare it only against
    :func:`gof_pvalue`'s bootstrap distribution, which carries the same
    shift.

    :param counts: observed count tensor(s); default: the likelihood's
      ``set_data`` histogram.
    :return: (t, free-fit ToyResults with one row).
    """
    if not hasattr(study, 'observed_counts'):
        raise TypeError(
            "the saturated-model GOF is a binned construction (an unbinned "
            "saturated density is unbounded); bin the data or use a "
            "binned study")
    counts = study.observed_counts(counts)
    res = study.fit_toys(tree_map(lambda c: c[None], counts), fixed=fixed)
    t = 2.0 * (saturated_logl(study, counts) - float(res.max_ll[0]))
    return float(t), res


def gof_pvalue(study, seed_or_generator, n_toys, counts=None, truth=None,
               fixed=None, mesh=None):
    """Toy-calibrated goodness-of-fit p-value (parametric bootstrap).

    Simulates ``n_toys`` datasets at ``truth`` — by default the OBSERVED
    best fit plus any ``fixed`` values, the standard bootstrap — fits each
    with the same fitter, and returns the add-one-smoothed
    fraction whose statistic reaches the observed one. A small p means the
    model cannot describe the data ("bad fit"); p near 1 means the data is
    suspiciously closer to the model than Poisson fluctuations allow.

    :return: dict with 't_obs', 'p', 't_toys' ((n_toys,)), 'truth' (the
      bootstrap parameters used), 'fit' (the observed-fit ToyResults row).
    """
    t_obs, fit = gof_ts(study, counts=counts, fixed=fixed)
    if truth is None:
        truth = {n: float(np.asarray(fit[n])[0]) for n in fit.names}
        truth.update(fixed or {})
    else:
        truth = simulation_truth(truth, fixed)
    toys = study.simulate(seed_or_generator, n_toys, truth, mesh)
    toy_res = study.fit_toys(toys, fixed=fixed)
    sat = saturated_logl(study, toys, batched=True)
    t_toys = 2.0 * (np.asarray(sat) - np.asarray(toy_res.max_ll))
    p = float(tail_fraction(np.sort(t_toys), t_obs))
    return {'t_obs': t_obs, 'p': float(p), 't_toys': t_toys,
            'truth': dict(truth), 'fit': fit}
