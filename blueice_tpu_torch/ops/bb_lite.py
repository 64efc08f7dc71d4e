"""Barlow-Beeston "lite" MC-statistics handling: one profiled scale per bin
on the TOTAL template, with its closed-form root.

Counterpart of :mod:`blueice_tpu.ops.bb_lite`. Every bin gets one nuisance
scale gamma_b on its total expectation, constrained by the bin's total MC
count M_b via a Poisson term normalized to zero at gamma = 1, and profiled
out analytically:

    LL_b(lam) = max_gamma [ k ln(gamma lam) - gamma lam
                            + M ln(gamma) - M (gamma - 1) ]
    gamma*    = (k + M) / (lam + M)                      (M > 0)

M = 0 bins carry no nuisance (gamma = 1). Three paths share the closed form:
the compiled likelihood value (:func:`bb_lite_logl`), the host float64
oracle (:func:`bb_lite_logl_host`), and the fit engine's value, gradient
and Hessian (:func:`binned_bblite_vgh`, batched over leading dimensions).
"""

import numpy as np
import torch

from .binned_vgh import corner_weight_tables
from .poisson import binned_poisson_logl_constant

__all__ = ['bb_lite_logl', 'bb_lite_logl_host', 'binned_bblite_vgh',
           'binned_bblite_ll', 'bblite_ll_from_morphed',
           'bblite_vgh_from_corners']

_PEN = 1e6     # negative-expectation penalty slope (matches ops.poisson)


def _gamma(lam_pos, M, k):
    """The profiled per-bin scale: (k+M)/(lam+M) with MC information, exactly
    1 elsewhere."""
    den = torch.clamp(lam_pos + M, min=torch.finfo(lam_pos.dtype).tiny)
    return torch.where(M > 0, (k + M) / den, torch.ones_like(den))


def bb_lite_logl(mus, pmfs, nme, observed, include_constant=True):
    """Binned Poisson log likelihood with the profiled lite per-bin scale;
    same conventions as :func:`blueice_tpu_torch.ops.poisson.
    binned_poisson_logl` (deviance-centered, steep linear penalty on
    negative expectations).

    :param mus: (n_sources,) expected counts per source.
    :param pmfs: (n_sources, *bins) per-source PMFs.
    :param nme: (n_sources, *bins) MC counts behind each template (summed
      over sources per bin inside).
    :param observed: (*bins,) observed counts.
    """
    lam = torch.tensordot(mus, pmfs, dims=([0], [0]))
    M = torch.sum(nme.to(lam.dtype), dim=0)
    tiny = torch.finfo(lam.dtype).tiny
    lam_pos = torch.clamp(lam, min=tiny)
    k = observed.to(lam.dtype)
    g = _gamma(lam_pos, M, k)
    k_safe = torch.where(observed > 0, observed, torch.ones_like(observed))
    ll = torch.sum(torch.xlogy(k, torch.clamp(g * lam_pos, min=tiny) / k_safe)
                   - (g * lam - k) + torch.xlogy(M, g) - M * (g - 1.0))
    ll = ll + _PEN * torch.sum(torch.clamp(lam, max=0.0))
    if include_constant:
        ll = ll + binned_poisson_logl_constant(observed)
    return ll


def bb_lite_logl_host(mus, pmfs, nme, observed):
    """Float64 numpy twin of :func:`bb_lite_logl` (constant included): the
    host likelihood's path."""
    from scipy.special import gammaln, xlogy
    lam = np.tensordot(np.asarray(mus, dtype=float),
                       np.asarray(pmfs, dtype=float), axes=(0, 0))
    M = np.sum(np.asarray(nme, dtype=float), axis=0)
    observed = np.asarray(observed, dtype=float)
    lam_pos = np.maximum(lam, np.finfo(float).tiny)
    with np.errstate(divide='ignore', invalid='ignore'):
        g = np.where(M > 0, (observed + M) / (lam_pos + M), 1.0)
    ll = float(np.sum(xlogy(observed, g * lam_pos) - g * lam
                      - gammaln(observed + 1.0)
                      + xlogy(M, g) - M * (g - 1.0)))
    return ll + _PEN * float(np.sum(np.minimum(lam, 0.0)))


def _per_bin_parts(lam, M, k):
    """Per-bin (value, f_lam, f_M, H_ll, H_lM, H_MM) of the profiled lite
    likelihood as a function of (lam, M), deviance-centered, with the
    negative-lam penalty folded into value and f_lam (its own curvature is 0
    a.e.)."""
    tiny = torch.finfo(lam.dtype).tiny
    lam_pos = torch.clamp(lam, min=tiny)
    has_mc = M > 0
    den = torch.clamp(lam_pos + M, min=tiny)
    one = torch.ones_like(den)
    zero = torch.zeros_like(den)
    g = torch.where(has_mc, (k + M) / den, one)
    k_safe = torch.where(k > 0, k, torch.ones_like(k))

    value = (torch.xlogy(k, torch.clamp(g * lam_pos, min=tiny) / k_safe)
             - (g * lam - k) + torch.xlogy(M, g) - M * (g - 1.0)
             + _PEN * torch.clamp(lam, max=0.0))

    inv_lam = 1.0 / lam_pos
    f_lam = k * inv_lam - g + _PEN * (lam < 0).to(lam.dtype)
    g_safe = torch.where(has_mc, g, one)
    f_M = torch.where(has_mc, torch.log(g_safe) - (g - 1.0), zero)

    # gamma partials (zero where there is no MC: gamma is pinned at 1)
    inv_den = torch.where(has_mc, 1.0 / den, zero)
    g_lam = torch.where(has_mc, -g * inv_den, zero)
    g_M = torch.where(has_mc, (lam_pos - k) * inv_den * inv_den, zero)

    # Envelope second derivatives along the profiled root
    H_ll = -k * inv_lam * inv_lam - g_lam
    H_lM = -g_M
    H_MM = torch.where(has_mc, (1.0 / g_safe - 1.0) * g_M, zero)
    return value, f_lam, f_M, H_ll, H_lM, H_MM


def bblite_ll_from_morphed(P, Mn, m, observed):
    """Value-only deviance-form lite LL (...) from the morphed pmfs
    (..., S, N) and the morphed total MC counts Mn (..., N)."""
    lam = torch.einsum('...s,...sn->...n', m, P)
    return torch.sum(_per_bin_parts(lam, Mn, observed)[0], dim=-1)


def bblite_vgh_from_corners(corners_ps, corners_tot, m, t, observed):
    """Deviance-form lite (ll, g, H) in (m, t) from the pmf corner blocks
    (..., 2^K, S, N) and the total-MC-count corner rows (..., 2^K, N):

        lam_n = sum_s m_s P_{s,n}(t),   M_n = sum_c w_c(t) N_{c,n}
    """
    K = t.shape[-1]
    S = m.shape[-1]
    w, wd, wx = corner_weight_tables(t)
    P = torch.einsum('...c,...csn->...sn', w, corners_ps)
    Mn = torch.einsum('...c,...cn->...n', w, corners_tot)
    lam = torch.einsum('...s,...sn->...n', m, P)
    value, f_lam, f_M, H_ll, H_lM, H_MM = _per_bin_parts(lam, Mn, observed)
    ll = torch.sum(value, dim=-1)

    g_m = torch.einsum('...sn,...n->...s', P, f_lam)
    H_mm = torch.einsum('...sn,...n,...zn->...sz', P, H_ll, P)
    if not K:
        return ll, g_m, H_mm
    D = torch.einsum('...kc,...csn->...ksn', wd, corners_ps)
    DM = torch.einsum('...kc,...cn->...kn', wd, corners_tot)
    X = torch.einsum('...dec,...csn->...desn', wx, corners_ps)
    XM = torch.einsum('...dec,...cn->...den', wx, corners_tot)
    Dbar = torch.einsum('...s,...ksn->...kn', m, D)
    Xbar = torch.einsum('...s,...desn->...den', m, X)
    g_t = (torch.einsum('...kn,...n->...k', Dbar, f_lam)
           + torch.einsum('...kn,...n->...k', DM, f_M))
    H_mt = (torch.einsum('...sn,...n,...kn->...sk', P, H_ll, Dbar)
            + torch.einsum('...sn,...n,...kn->...sk', P, H_lM, DM)
            + torch.einsum('...ksn,...n->...sk', D, f_lam))
    H_tt = (torch.einsum('...kn,...n,...en->...ke', Dbar, H_ll, Dbar)
            + torch.einsum('...kn,...n,...en->...ke', Dbar, H_lM, DM)
            + torch.einsum('...kn,...n,...en->...ke', DM, H_lM, Dbar)
            + torch.einsum('...kn,...n,...en->...ke', DM, H_MM, DM)
            + torch.einsum('...ken,...n->...ke', Xbar, f_lam)
            + torch.einsum('...ken,...n->...ke', XM, f_M))
    g = torch.cat([g_m, g_t], dim=-1)
    top = torch.cat([H_mm, H_mt], dim=-1)
    bottom = torch.cat([H_mt.transpose(-1, -2), H_tt], dim=-1)
    return ll, g, torch.cat([top, bottom], dim=-2)


def binned_bblite_vgh(corners, nme_corners, m, t, observed):
    """Deviance-form lite LL, gradient and Hessian w.r.t. (m, t).

    :param corners: (..., 2^K, S, N) pmf corner templates.
    :param nme_corners: (..., 2^K, S, N) MC-count corner templates (summed
      over sources inside).
    :param m: (..., S); t: (..., K); observed: (..., N).
    :return: (ll, g (..., S+K), H (..., S+K, S+K)); saturated constant
      excluded.
    """
    return bblite_vgh_from_corners(corners, nme_corners.sum(-2), m, t,
                                   observed)


def binned_bblite_ll(corners, nme_corners, m, t, observed):
    """Value-only deviance-form lite LL on the corner blocks (the line-search
    evaluation; excludes the saturated constant)."""
    w = corner_weight_tables(t)[0]
    P = torch.einsum('...c,...csn->...sn', w, corners)
    Mn = torch.einsum('...c,...cn->...n', w, nme_corners.sum(-2))
    return bblite_ll_from_morphed(P, Mn, m, observed)
