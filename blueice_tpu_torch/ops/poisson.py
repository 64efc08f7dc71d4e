"""Likelihood reductions in torch: Poisson bin sums and the extended
unbinned likelihood, with the numpy host twin of the latter.

Counterpart of :mod:`blueice_tpu.ops.poisson`. The binned sums keep the
deviance-centered form: the parameter-dependent part of the sum stays
O(n_dof) in magnitude, so float32 resolves the likelihood differences
profile statistics need.
"""

import numpy as np
import torch

__all__ = ['poisson_logpmf', 'poisson_logpmf_np', 'binned_poisson_logl',
           'binned_poisson_logl_constant', 'extended_logl', 'extended_logl_np']


def poisson_logpmf(k, mu):
    """log PMF of Poisson(mu) at counts k, on tensors. mu == 0 gives 0 at
    k == 0 and -inf elsewhere (as scipy.stats.poisson.logpmf)."""
    k = torch.as_tensor(k)
    mu = torch.as_tensor(mu)
    if not k.is_floating_point():
        k = k.to(mu.dtype if mu.is_floating_point()
                 else torch.get_default_dtype())
    return torch.xlogy(k, mu) - mu - torch.lgamma(k + 1.0)


def poisson_logpmf_np(k, mu):
    """Numpy (float64) twin of :func:`poisson_logpmf` for the host."""
    from scipy.special import gammaln, xlogy
    k = np.asarray(k, dtype=float)
    mu = np.asarray(mu, dtype=float)
    return xlogy(k, mu) - mu - gammaln(k + 1.0)


def binned_poisson_logl(mus, pmfs, observed, include_constant=True):
    """Binned Poisson log likelihood.

    :param mus: (n_sources,) expected event counts per source.
    :param pmfs: (n_sources, *bins) per-source PMF over the analysis bins.
    :param observed: (*bins,) observed counts.
    :param include_constant: include the parameter-independent
      -lgamma(k+1) part (see :func:`binned_poisson_logl_constant`).
    :return: scalar: sum over bins of Poisson(sum_s mu_s pmf_s), with
      zero-expectation bins floored at the dtype's smallest normal inside
      the log and a steep linear penalty on negative expectations.
    """
    expected = torch.tensordot(mus, pmfs, dims=([0], [0]))
    tiny = torch.finfo(expected.dtype).tiny
    k_safe = torch.where(observed > 0, observed, torch.ones_like(observed))
    ll = torch.sum(torch.xlogy(observed,
                               torch.clamp(expected, min=tiny) / k_safe)
                   - (expected - observed))
    ll = ll + 1e6 * torch.sum(torch.clamp(expected, max=0.0))
    if include_constant:
        ll = ll + binned_poisson_logl_constant(observed)
    return ll


def binned_poisson_logl_constant(observed, batch_dims=0):
    """The parameter-independent (saturated-model) term of the binned
    Poisson log likelihood: sum of k*log(k) - k - lgamma(k+1) over the bins.

    :param batch_dims: number of leading batch (toy) dimensions kept.
    """
    k_safe = torch.where(observed > 0, observed, torch.ones_like(observed))
    terms = torch.xlogy(observed, k_safe) - observed - torch.lgamma(
        observed + 1.0)
    return terms.reshape(tuple(observed.shape[:batch_dims]) + (-1,)).sum(-1)


def extended_logl(mus, ps, outlier_likelihood=0.0, mask=None, center=None):
    """Extended unbinned log likelihood.

    :param mus: (n_sources,) expected number of events per source.
    :param ps: (n_sources, n_events) pdf value of each source at each event.
    :param outlier_likelihood: density given to events whose summed density
      is not a positive number (0, negative or nan), so that one
      zero-density event cannot sink the whole likelihood.
    :param mask: optional (n_events,) boolean; False entries are padding and
      contribute nothing.
    :param center: optional ``(inv_ref (n_events,), ref_msum)``: the
      centered value ``-(sum(mus) - ref_msum) + sum_events log(lam_e *
      inv_ref_e)``, as the closed forms center
      (:func:`blueice_tpu_torch.ops.unbinned_vgh.reference_center`).
    :return: scalar: -sum(mus) + sum_events log(sum_s mu_s p_s(event)).
    """
    p_events = torch.nansum(mus[:, None] * ps, dim=0)
    if mask is not None:
        # Double-where: floor the padded events' density before the log, so
        # no log(0) = -inf stays in the computation
        p_events = torch.where(mask, p_events, torch.ones_like(p_events))
    if outlier_likelihood != 0:
        p_events = torch.where(p_events > 0, p_events,
                               torch.full_like(p_events, outlier_likelihood))
    rate = torch.sum(mus)
    if center is not None:
        p_events = p_events * center[0]
        rate = rate - center[1]
    log_terms = torch.log(p_events)
    if mask is not None:
        log_terms = torch.where(mask, log_terms, torch.zeros_like(log_terms))
    return -rate + torch.sum(log_terms)


def extended_logl_np(mus, ps, outlier_likelihood=0.0, mask=None):
    """Numpy (float64) twin of :func:`extended_logl`: the host likelihood's
    reduction (``UnbinnedLogLikelihood._compute_likelihood``)."""
    mus = np.asarray(mus, dtype=float)
    ps = np.asarray(ps, dtype=float)
    p_events = np.nansum(mus[:, None] * ps, axis=0)
    if mask is not None:
        p_events = np.where(mask, p_events, 1.0)
    if outlier_likelihood != 0:
        p_events = np.where(p_events > 0, p_events, outlier_likelihood)
    with np.errstate(divide='ignore', invalid='ignore'):
        log_terms = np.log(p_events)
    if mask is not None:
        log_terms = np.where(mask, log_terms, 0.0)
    return float(-mus.sum() + np.sum(log_terms))
