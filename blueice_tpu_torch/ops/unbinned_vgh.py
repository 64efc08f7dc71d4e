"""Analytic value+gradient+Hessian of the extended unbinned log likelihood in
the (rate, morph-weight) parameterization, batched over toys.

Counterpart of :mod:`blueice_tpu.ops.unbinned_vgh`. The JAX functions take
one event set and are vmapped; these take any number of leading batch
dimensions written out (``...`` below). The per-event density of source s,
``P_{s,e}(t)``, is multilinear in the lerp weights over the anchor corner
templates, and

    ll(m, t) = -sum_s m_s + sum_e mask_e * log(lam_e),
    lam_e    = sum_s m_s * P_{s,e}(t),

so every derivative has a closed form in the corner templates, as in the
binned case (:mod:`blueice_tpu_torch.ops.binned_vgh`). Events whose summed
density is not positive take the ``outlier_likelihood`` floor in the value
and contribute no gradient or curvature (the floor is a constant).

:func:`vgh_parts` is the plain version behind the fused unbinned vgh kernel
(:mod:`blueice_tpu_torch.ops.fused_unbinned`, whose plain versions are the
engine of ``engine='analytic'``) and :func:`reference_center` centers every
fit. :func:`unbinned_vgh` and :func:`unbinned_ll` take a corner block as the
JAX functions do; the fitter does not call them (it reads the per-toy
tensor through a lane index instead), and they are kept as the surface the
parity tests hold against the JAX package.
"""

import torch

from .binned_vgh import corner_weight_tables

__all__ = ['unbinned_vgh', 'unbinned_ll', 'reference_center']


def _lam_eff(lam, outlier_likelihood):
    if outlier_likelihood == 0:
        return lam
    return torch.where(lam > 0, lam,
                       torch.full_like(lam, outlier_likelihood))


def _log_sum(lam, mask, outlier_likelihood, inv_ref, sum_dtype=None):
    """sum_e mask_e log(lam_eff_e [* inv_ref_e]) over the last axis (summed
    in ``sum_dtype``, default the terms' own)."""
    arg = _lam_eff(lam, outlier_likelihood)
    if inv_ref is not None:
        arg = arg * inv_ref
    return torch.sum(torch.where(mask, torch.log(arg),
                                 torch.zeros_like(arg)), dim=-1,
                     dtype=sum_dtype)


def _rate_term(m, ref_msum, centered):
    """The rate part of the value: -sum m, or -(sum m - ref_msum)."""
    msum = m.sum(-1)
    return -(msum - ref_msum) if centered else -msum


def vgh_parts(corners, m, t, mask, outlier_likelihood=0.0, inv_ref=None,
              sum_dtype=None):
    """(log-term sum (...), g (..., S+K), H (..., S+K, S+K)) of the extended
    LL: everything but the rate part of the value, which the caller
    subtracts (``sum m`` uncentered, ``sum m - ref_msum`` centered).

    Every per-event quantity is in the corners' dtype; with ``sum_dtype``
    the sums over events are in that dtype instead (float32 events summed
    in float64 is float32's own error on each event's terms, as the fused
    kernel sums g: at a converged fit g is a sum of large terms that
    nearly cancel, and a float32 sum of them loses more than that)."""
    K = t.shape[-1]
    dtype = corners.dtype

    def esum(eq, *ops):
        """``torch.einsum(eq, *ops)``, whose operands all end in the event
        axis and whose output drops it, summed over events in
        ``sum_dtype``."""
        if sum_dtype is None:
            return torch.einsum(eq, *ops)
        return torch.einsum(eq + 'e', *ops).to(sum_dtype).sum(-1)
    w, wd, wx = corner_weight_tables(t)
    P = torch.einsum('...c,...cse->...se', w, corners)         # (..., S, E)
    lam = torch.einsum('...s,...se->...e', m, P)               # (..., E)
    log_sum = _log_sum(lam, mask, outlier_likelihood, inv_ref, sum_dtype)

    pos = lam > 0
    lam_safe = torch.where(pos, lam, torch.ones_like(lam))
    inv = (mask & pos).to(dtype) / lam_safe                    # (..., E)
    q = inv / lam_safe

    g_m = esum('...se,...e->...s', P, inv) - 1.0
    H_mm = -esum('...se,...e,...ze->...sz', P, q, P)
    if K == 0:
        return log_sum, g_m, H_mm
    D = torch.einsum('...kc,...cse->...kse', wd, corners)      # (..., K, S, E)
    Dbar = torch.einsum('...s,...kse->...ke', m, D)            # (..., K, E)
    g_t = esum('...ke,...e->...k', Dbar, inv)
    H_mt = (-esum('...se,...e,...ke->...sk', P, q, Dbar)
            + esum('...kse,...e->...sk', D, inv))
    # Xbar_kz = sum_s m_s d2P_s/dt_k dt_z, through each corner's lam_c, so
    # the (..., K, K, S, E) table is never formed
    lam_c = torch.einsum('...s,...cse->...ce', m, corners)     # (..., C, E)
    Xbar = torch.einsum('...kzc,...ce->...kze', wx, lam_c)
    H_tt = (-esum('...ke,...e,...ze->...kz', Dbar, q, Dbar)
            + esum('...kze,...e->...kz', Xbar, inv))
    g = torch.cat([g_m, g_t], dim=-1)
    top = torch.cat([H_mm, H_mt], dim=-1)
    bottom = torch.cat([H_mt.transpose(-1, -2), H_tt], dim=-1)
    return log_sum, g, torch.cat([top, bottom], dim=-2)


def unbinned_vgh(corners, m, t, mask, outlier_likelihood=0.0, inv_ref=None,
                 ref_msum=0.0):
    """Extended-LL value, gradient and Hessian w.r.t. (m, t).

    :param corners: (..., 2^K, S, E) per-event density corner templates
      around the query point (K inferred from t).
    :param m: (..., S) per-source expected counts.
    :param t: (..., K) per-axis lerp weights.
    :param mask: (..., E) boolean validity mask (False = padding).
    :param outlier_likelihood: density floor for non-positive summed
      densities.
    :param inv_ref: optional (..., E) inverse per-event reference densities:
      the value becomes the centered log likelihood
      ``-(sum m - ref_msum) + sum_e log(lam_e * inv_ref_e)``, every term
      O(1), so float32 keeps the differences a fit needs (see
      :func:`reference_center`). Gradient and Hessian are unchanged.
    :param ref_msum: (...) sum of the reference expected counts (with
      ``inv_ref``).
    :return: (ll (...), g (..., S+K), H (..., S+K, S+K)), parameter order
      [m_1..S, t_1..K].
    """
    log_sum, g, H = vgh_parts(corners, m, t, mask, outlier_likelihood,
                              inv_ref)
    return _rate_term(m, ref_msum, inv_ref is not None) + log_sum, g, H


def unbinned_ll(corners, m, t, mask, outlier_likelihood=0.0, inv_ref=None,
                ref_msum=0.0):
    """Value-only extended LL on corner blocks (..., 2^K, S, E); with
    ``inv_ref``, the centered value (see :func:`unbinned_vgh`)."""
    w = corner_weight_tables(t)[0]
    P = torch.einsum('...c,...cse->...se', w, corners)
    lam = torch.einsum('...s,...se->...e', m, P)
    return (_rate_term(m, ref_msum, inv_ref is not None)
            + _log_sum(lam, mask, outlier_likelihood, inv_ref))


def reference_center(corners, m, t, mask, outlier_likelihood=0.0):
    """Per-toy centering data at a fixed reference point:
    ``(inv_ref (..., E), ref_msum (...), ref_ll (...))``. Feed the first two
    to :func:`unbinned_ll` / :func:`unbinned_vgh` and add ``ref_ll`` back to
    an optimum for the absolute log likelihood. ``inv_ref`` is 1 where an
    event is masked or its reference density is not positive. ``ref_ll`` is
    summed and returned in float64 whatever the working type (it is computed
    once per event set, and a float32 total of a few thousand log terms
    would round at ~1e-3)."""
    w = corner_weight_tables(t)[0]
    P = torch.einsum('...c,...cse->...se', w, corners)
    lam_eff = _lam_eff(torch.einsum('...s,...se->...e', m, P),
                       outlier_likelihood)
    ok = lam_eff > 0
    safe = torch.where(ok, lam_eff, torch.ones_like(lam_eff))
    inv_ref = torch.where(mask & ok, 1.0 / safe, torch.ones_like(safe))
    ref_msum = m.sum(-1)
    logs = torch.where(mask, torch.log(safe), torch.zeros_like(safe))
    ref_ll = -ref_msum.to(torch.float64) + logs.to(torch.float64).sum(-1)
    return inv_ref, ref_msum, ref_ll
