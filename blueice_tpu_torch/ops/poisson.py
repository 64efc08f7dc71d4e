"""Binned Poisson likelihood reductions in torch.

Counterpart of :mod:`blueice_tpu.ops.poisson` (the binned half; the extended
unbinned likelihood is ROADMAP queue 1 item 9). Same deviance-centered form:
the parameter-dependent part of the sum stays O(n_dof) in magnitude, so
float32 resolves the likelihood differences profile statistics need.
"""

import torch

__all__ = ['binned_poisson_logl', 'binned_poisson_logl_constant']


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
