"""Beeston-Barlow finite-MC-statistics correction (single finite source), in
torch.

Counterpart of :mod:`blueice_tpu.ops.beeston_barlow`. When one source's
template comes from a finite Monte-Carlo sample, its per-bin expected counts
are nuisance parameters constrained by Poisson terms around the MC counts;
with the other sources exact, the profile over each has a closed-form
per-bin quadratic root (Beeston & Barlow 1993; reference:
blueice/likelihood.py:618-660, 693-712). The host float64 twins of the roots
live in :mod:`blueice_tpu_torch.likelihood`.
"""

import torch

__all__ = ['beeston_barlow_root1', 'beeston_barlow_root2',
           'beeston_barlow_roots', 'bb_single_adjust']


def _bb_quadratic_parts(a, p, U, d):
    """(A2, b, s) of the per-bin quadratic A2*x^2 + b*x + c with c = -U*a and
    s = sqrt(b^2 + 4*A2*U*a): every term of the discriminant is
    nonnegative, so it is cancellation-free; floored at tiny."""
    A2 = p * (p + 1.0)
    b = U * (p + 1.0) - p * (a + d)
    disc = b * b + 4.0 * A2 * (U * a)
    s = torch.sqrt(torch.clamp(disc, min=torch.finfo(disc.dtype).tiny))
    return A2, b, s


def _as_tensors(*xs):
    like = next((x for x in xs if torch.is_tensor(x)), None)
    dtype = like.dtype if like is not None else torch.float64
    device = like.device if like is not None else None
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in xs]


def beeston_barlow_root1(a, p, U, d):
    """The unphysical (non-positive) root of the per-bin quadratic, kept for
    regression checks like the reference's."""
    a, p, U, d = _as_tensors(a, p, U, d)
    A2, b, s = _bb_quadratic_parts(a, p, U, d)
    tiny = torch.finfo(b.dtype).tiny
    sel = b >= 0
    one = torch.ones_like(b)
    den_hi = torch.clamp(torch.where(sel, 2.0 * A2, one), min=tiny)
    den_lo = torch.clamp(torch.where(sel, one, s - b), min=tiny)
    return torch.where(sel, -(b + s) / den_hi, -2.0 * U * a / den_lo)


def beeston_barlow_root2(a, p, U, d):
    """The physical root of the per-bin quadratic, in the cancellation-free
    form per sign of the linear coefficient (Citardauq for b >= 0).

    :param a: MC counts per bin of the finite source.
    :param p: data/MC rate ratio per bin (or scalar).
    :param U: expected counts per bin of all other sources.
    :param d: observed counts per bin.
    """
    a, p, U, d = _as_tensors(a, p, U, d)
    A2, b, s = _bb_quadratic_parts(a, p, U, d)
    tiny = torch.finfo(b.dtype).tiny
    sel = b >= 0
    one = torch.ones_like(b)
    den_hi = torch.clamp(torch.where(sel, b + s, one), min=tiny)
    den_lo = torch.clamp(torch.where(sel, one, 2.0 * A2), min=tiny)
    return torch.where(sel, 2.0 * U * a / den_hi, (s - b) / den_lo)


def beeston_barlow_roots(a, p, U, d):
    return beeston_barlow_root1(a, p, U, d), beeston_barlow_root2(a, p, U, d)


def bb_single_adjust(mus, pmfs, n_model_events, observed, source_i):
    """Adjust (mus, pmfs) for the finite MC statistics of source
    ``source_i``.

    :param mus: (n_sources,) expected counts per source (rate-multiplied).
    :param pmfs: (n_sources, *bins) per-source PMFs.
    :param n_model_events: (n_sources, *bins) MC counts behind each PMF.
    :param observed: (*bins,) observed counts.
    :param source_i: int index of the finite-statistics source.
    :return: (mus, pmfs) with the finite source's pmf and mu replaced by the
      profiled Beeston-Barlow solution (U == 0 bins use the separate closed
      form, since the general root is singular there).
    """
    dt = pmfs.dtype
    n_model_events = n_model_events.to(dt)
    observed = observed.to(dt)
    n_sources = mus.shape[0]
    other = (torch.arange(n_sources, device=mus.device) != source_i).to(dt)
    u_bins = torch.tensordot(mus * other, pmfs, dims=([0], [0]))

    a_bins = n_model_events[source_i]
    n_mc_total = torch.sum(a_bins)
    p_calibration = mus[source_i] / n_mc_total
    zero = torch.zeros_like(a_bins)
    safe_a = torch.where(a_bins > 0, a_bins, torch.ones_like(a_bins))
    w_calibration = torch.where(a_bins > 0,
                                pmfs[source_i] / safe_a * n_mc_total, zero)

    # Empty-MC bins (w == 0) make the general root 0/0: evaluate it at a
    # safe p there and zero the result afterwards
    p_eff = torch.where(w_calibration > 0, w_calibration * p_calibration,
                        torch.ones_like(w_calibration))
    A_general = beeston_barlow_root2(a_bins, p_eff, u_bins, observed)
    # U == 0 bins: the reference's special case with the bare p_calibration
    A_special = (observed + a_bins) / (1.0 + p_calibration)
    A_bins = torch.where(u_bins == 0, A_special, A_general)
    A_bins = torch.where(w_calibration > 0, A_bins, zero)

    new_raw = A_bins * w_calibration
    mus = mus.clone()
    pmfs = pmfs.clone()
    mus[source_i] = torch.sum(new_raw) * p_calibration
    pmfs[source_i] = new_raw / torch.sum(new_raw)
    return mus, pmfs
