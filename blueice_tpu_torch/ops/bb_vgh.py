"""Analytic value+gradient+Hessian of the Beeston-Barlow-adjusted binned
Poisson likelihood in the (rate, morph-weight) parameterization, batched
over toys.

Counterpart of :mod:`blueice_tpu.ops.bb_vgh`. The JAX functions take one
dataset and are vmapped; these take any number of leading batch dimensions
written out (``...`` below).

After the adjustment of source ``bb_i`` (reference:
blueice/likelihood.py:618-660) the expected count in bin n is

    lam_n = U_n + pw_n * A_n,      pw_n = m_i * P_n / N_n,

a scalar function of five per-bin inputs (P, N, U, M, T): the morphed pmf
and MC counts of the finite source, the other sources' expectation, the
finite source's rate and its total MC count T = sum_n N_n (which enters only
through the U == 0 special case). :func:`bb_lam_parts` gives its gradient
and Hessian in those inputs in closed form (implicit differentiation of the
per-bin quadratic); the chain to (m, t) is closed form because the inputs
are multilinear in the corner templates.

The autodiff twins the JAX module keeps as a test oracle are not ported: the
tests hold these closed forms against the JAX functions directly.
"""

import torch

from .binned_vgh import corner_weight_tables

__all__ = ['bb_lambda', 'bb_lam_parts', 'bb_lam_vgh', 'binned_bb_vgh',
           'binned_bb_ll', 'bb_vgh_from_corners', 'bb_ll_from_morphed']


def bb_lambda(P, N, U, M, T, d):
    """Beeston-Barlow-adjusted expected count per bin (elementwise).

    :param P: morphed pmf of the finite-MC source.
    :param N: morphed MC counts of the finite-MC source.
    :param U: expected counts from all other sources.
    :param M: expected total counts of the finite-MC source.
    :param T: total MC counts of the finite source over all bins.
    :param d: observed counts.
    """
    tiny = torch.finfo(P.dtype).tiny
    has_mc = N > 0
    N_safe = torch.where(has_mc, N, 1.0)
    pw = torch.where(has_mc, M * P / N_safe, 0.0)
    pw_safe = torch.where(pw > 0, pw, 1.0)

    # General root of the per-bin quadratic in the cancellation-free form:
    # discriminant b^2 + 4*a*U*N (every term nonnegative), Citardauq for
    # b >= 0, each branch's denominator guarded before the division
    b_lin = U * (pw_safe + 1.0) - pw_safe * (N + d)
    disc = b_lin * b_lin + 4.0 * pw_safe * (pw_safe + 1.0) * (U * N)
    root = torch.sqrt(torch.clamp(disc, min=tiny))
    sel_hi = b_lin >= 0
    den_hi = torch.clamp(torch.where(sel_hi, b_lin + root, 1.0), min=tiny)
    den_lo = torch.where(sel_hi, 1.0, 2.0 * pw_safe * (pw_safe + 1.0))
    A_general = torch.where(sel_hi, 2.0 * U * N / den_hi,
                            (root - b_lin) / den_lo)
    # U == 0 bins: the dedicated closed form, coupled to the MC total
    A_special = (d + N) / (1.0 + M / T)
    A = torch.where(U == 0, A_special, A_general)
    return U + torch.where(pw > 0, pw * A, 0.0)


def bb_lam_parts(P, N, U, M, T, d):
    """Closed-form value, gradient and Hessian of :func:`bb_lambda` in its
    five inputs, elementwise, with the branch structure of the JAX twin:
    inert bins (pw <= 0: lam = U), the U == 0 special root, the general root
    (Citardauq for b >= 0), the ``tiny`` floors and the finite dlam/dM limit
    at exactly M == 0.

    :return: (lam, gam, om): gam a 5-tuple of d lam / d(P, N, U, M, T); om a
      dict {(i, j): d2 lam} over upper-triangle input pairs i <= j (absent
      keys are identically zero).
    """
    tiny = torch.finfo(P.dtype).tiny
    has_mc = N > 0
    N_s = torch.where(has_mc, N, 1.0)
    p = torch.where(has_mc, M * P / N_s, 0.0)
    active = p > 0
    p_s = torch.where(active, p, 1.0)

    # ---- general branch (active, U != 0) ----
    a = p_s * (p_s + 1.0)
    b = U * (p_s + 1.0) - p_s * (N + d)
    disc = b * b + 4.0 * U * N * a
    R = torch.sqrt(torch.clamp(disc, min=tiny))
    sel_hi = b >= 0
    den_hi = torch.clamp(torch.where(sel_hi, b + R, 1.0), min=tiny)
    den_lo = torch.where(sel_hi, 1.0, 2.0 * a)
    A = torch.where(sel_hi, 2.0 * U * N / den_hi, (R - b) / den_lo)

    F_p = (2.0 * p_s + 1.0) * A * A + (U - N - d) * A
    F_U = (p_s + 1.0) * A - N
    F_N = -p_s * A - U
    inv_R = 1.0 / R
    A_p = -F_p * inv_R
    A_U = -F_U * inv_R
    A_N = -F_N * inv_R

    F_pA = 2.0 * (2.0 * p_s + 1.0) * A + (U - N - d)
    F_UA = p_s + 1.0
    F_NA = -p_s
    two_a = 2.0 * a
    A_pp = -(2.0 * A * A + 2.0 * F_pA * A_p + two_a * A_p * A_p) * inv_R
    A_pU = -(A + F_pA * A_U + F_UA * A_p + two_a * A_p * A_U) * inv_R
    A_pN = -(-A + F_pA * A_N + F_NA * A_p + two_a * A_p * A_N) * inv_R
    A_UU = -(2.0 * F_UA * A_U + two_a * A_U * A_U) * inv_R
    A_UN = -(-1.0 + F_UA * A_N + F_NA * A_U + two_a * A_U * A_N) * inv_R
    A_NN = -(2.0 * F_NA * A_N + two_a * A_N * A_N) * inv_R

    L_p = A + p_s * A_p
    L_U = 1.0 + p_s * A_U
    L_N = p_s * A_N
    L_pp = 2.0 * A_p + p_s * A_pp
    L_pU = A_U + p_s * A_pU
    L_pN = A_N + p_s * A_pN
    L_UU = p_s * A_UU
    L_UN = p_s * A_UN
    L_NN = p_s * A_NN

    # pw = M P / N partials
    inv_N = 1.0 / N_s
    p_P = M * inv_N
    p_M = P * inv_N
    p_N = -p_s * inv_N
    p2_PN = -p_P * inv_N
    p2_PM = inv_N
    p2_NN = 2.0 * p_s * inv_N * inv_N
    p2_NM = -p_M * inv_N

    zero = torch.zeros_like(p)
    g_gen = (L_p * p_P, L_N + L_p * p_N, L_U, L_p * p_M, zero)
    o_gen = {
        (0, 0): L_pp * p_P * p_P,
        (0, 1): L_pp * p_P * p_N + L_pN * p_P + L_p * p2_PN,
        (0, 2): L_pU * p_P,
        (0, 3): L_pp * p_P * p_M + L_p * p2_PM,
        (1, 1): (L_pp * p_N * p_N + 2.0 * L_pN * p_N + L_NN
                 + L_p * p2_NN),
        (1, 2): L_pU * p_N + L_UN,
        (1, 3): L_pp * p_N * p_M + L_pN * p_M + L_p * p2_NM,
        (2, 2): L_UU,
        (2, 3): L_pU * p_M,
        (3, 3): L_pp * p_M * p_M,
    }

    # ---- special branch (active, U == 0): A = (d + N) / (1 + M / T) ----
    T_s = torch.where(T > 0, T, 1.0)
    beta = 1.0 + M / T_s
    inv_b = 1.0 / beta
    inv_T = 1.0 / T_s
    As = (d + N) * inv_b
    As_N = inv_b
    As_M = -As * inv_b * inv_T
    As_T = As * M * inv_b * inv_T * inv_T
    As_NM = -inv_b * inv_b * inv_T
    As_NT = M * inv_b * inv_b * inv_T * inv_T
    As_MM = 2.0 * (d + N) * inv_b ** 3 * inv_T * inv_T
    As_MT = (d + N) * (inv_b ** 2 * inv_T ** 2
                       - 2.0 * M * inv_b ** 3 * inv_T ** 3)
    As_TT = (d + N) * M * (2.0 * M * inv_b ** 3 * inv_T ** 4
                           - 2.0 * inv_b ** 2 * inv_T ** 3)

    g_spe = (p_P * As, p_N * As + p_s * As_N, torch.ones_like(p),
             p_M * As + p_s * As_M, p_s * As_T)
    o_spe = {
        (0, 1): p2_PN * As + p_P * As_N,
        (0, 3): p2_PM * As + p_P * As_M,
        (0, 4): p_P * As_T,
        (1, 1): p2_NN * As + 2.0 * p_N * As_N,
        (1, 3): p2_NM * As + p_N * As_M + p_M * As_N + p_s * As_NM,
        (1, 4): p_N * As_T + p_s * As_NT,
        (3, 3): 2.0 * p_M * As_M + p_s * As_MM,
        (3, 4): p_M * As_T + p_s * As_MT,
        (4, 4): p_s * As_TT,
    }

    # ---- select branches (inert bins: lam = U, d lam / dU = 1) ----
    special = active & (U == 0)
    general = active & (U != 0)
    A_sel = torch.where(special, As, A)
    lam = U + torch.where(active, p_s * A_sel, 0.0)

    gam = []
    for i in range(5):
        gi = torch.where(special, g_spe[i],
                         torch.where(general, g_gen[i], zero))
        if i == 2:
            gi = torch.where(active, gi, 1.0)
        gam.append(gi)
    # d lam / dM at exactly M == 0 on a real template bin: the finite limit
    # (the inert-branch gate would report 0 and pin a fit starting at 0)
    at_zero_M = has_mc & (P > 0) & (M == 0)
    gam3_lim = torch.where(
        U == 0, (P * torch.where(has_mc, 1.0 / N_s, 0.0)) * (d + N), P)
    gam[3] = torch.where(at_zero_M, gam3_lim, gam[3])
    om = {}
    for key in sorted(set(o_gen) | set(o_spe)):
        v = torch.where(general, o_gen.get(key, zero), zero)
        om[key] = torch.where(special, o_spe.get(key, zero), v)
    return lam, tuple(gam), om


def bb_lam_vgh(v, d):
    """Stacked layout over :func:`bb_lam_parts`: v (..., 5) ->
    (lam (...), gam (..., 5), om (..., 5, 5))."""
    lam, gam, om_d = bb_lam_parts(*(v[..., i] for i in range(5)), d)
    zero = torch.zeros_like(lam)
    om = torch.stack([torch.stack([om_d.get((min(i, j), max(i, j)), zero)
                                   for j in range(5)], dim=-1)
                      for i in range(5)], dim=-2)
    return lam, torch.stack(gam, dim=-1), om


def _deviance(lam, observed):
    """(ll (...), r (..., N), q (..., N)) of the deviance-form Poisson
    likelihood at expectations ``lam``: r = k/lam - 1, q = k/lam^2."""
    tiny = torch.finfo(lam.dtype).tiny
    lam_safe = torch.clamp(lam, min=tiny)
    k_safe = torch.where(observed > 0, observed, 1.0)
    ll = torch.sum(observed * torch.log(lam_safe / k_safe) - (lam - observed),
                   dim=-1)
    inv_lam = 1.0 / lam_safe
    return ll, observed * inv_lam - 1.0, (observed * inv_lam) * inv_lam


def _bb_inputs(P, Nb, m, bb_i):
    """(Pb, U, M, T, other-source mask, m_other) of the per-bin root."""
    S = m.shape[-1]
    other = (torch.arange(S, device=m.device) != bb_i).to(m.dtype)
    m_other = m * other
    U = torch.einsum('...s,...sn->...n', m_other, P)
    return (P[..., bb_i, :], U, m[..., bb_i:bb_i + 1],
            Nb.sum(-1, keepdim=True), other, m_other)


def bb_ll_from_morphed(P, Nb, m, observed, bb_i):
    """Value-only deviance-form LL (...) from the morphed pmfs P (..., S, N)
    and the finite source's morphed MC counts Nb (..., N); T is the
    straightforward sum of Nb over the bins."""
    Pb, U, M, T, _, _ = _bb_inputs(P, Nb, m, bb_i)
    return _deviance(bb_lambda(Pb, Nb, U, M, T, observed), observed)[0]


def bb_vgh_from_corners(corners_ps, corners_nb, m, t, observed, bb_i):
    """Deviance-form (ll, g, H) in (m, t) from the pmf corner blocks
    (..., 2^K, S, N) and the finite source's MC-count corner rows
    (..., 2^K, N).

    The curvature is assembled per input, as the Pallas kernel does: one
    (..., S+K, N) parameter-row tensor per input v of the root (bb pmf, bb
    counts, other-source expectation, bb rate, total counts), the r*om-
    weighted products of those rows, and the second derivatives of the
    inputs added from the difference tables directly, so the
    (..., N, 5, S+K, S+K) second-derivative tensor is never formed. Each
    bin's (S+K, S+K) curvature is summed over the inputs before the sum over
    the bins.
    """
    K = t.shape[-1]
    S = m.shape[-1]
    w, wd, wx = corner_weight_tables(t)
    P = torch.einsum('...c,...csn->...sn', w, corners_ps)
    Nb = torch.einsum('...c,...cn->...n', w, corners_nb)
    Pb, U, M, T, other, m_other = _bb_inputs(P, Nb, m, bb_i)
    lam, gam, om = bb_lam_parts(Pb, Nb, U, M, T, observed)
    ll, r, q = _deviance(lam, observed)

    zeros_S = torch.zeros(lam.shape[:-1] + (S, lam.shape[-1]),
                          dtype=lam.dtype, device=lam.device)
    onehot = (1.0 - other)[:, None].expand(zeros_S.shape)
    rows = [zeros_S, zeros_S, P * other[:, None], onehot, zeros_S]
    if K:
        D = torch.einsum('...kc,...csn->...ksn', wd, corners_ps)
        DN = torch.einsum('...kc,...cn->...kn', wd, corners_nb)
        DU = torch.einsum('...s,...ksn->...kn', m_other, D)
        zeros_K = torch.zeros_like(DN)
        t_rows = [D[..., bb_i, :], DN, DU, zeros_K,
                  DN.sum(-1, keepdim=True).expand(DN.shape)]
        rows = [torch.cat([a, b], dim=-2) for a, b in zip(rows, t_rows)]
    J = torch.stack(rows, dim=-3)                          # (..., 5, P, N)

    dlam = torch.einsum('...vn,...vpn->...pn', torch.stack(gam, dim=-2), J)
    g = torch.einsum('...pn,...n->...p', dlam, r)
    # Curvature per bin first, then the sum over bins: the per-input terms
    # cancel within a bin (H of a shape coordinate reaches ~1e7 at XENON
    # scale), and forming each bin's total before the bin sum keeps that
    # cancellation out of the reduction, as the kernel does
    zero = torch.zeros_like(lam)
    r_om = r[..., None, None, :] * torch.stack(
        [torch.stack([om.get((min(v, u), max(v, u)), zero)
                      for u in range(5)], dim=-2) for v in range(5)],
        dim=-3)                                            # (..., 5, 5, N)
    W = torch.einsum('...vun,...upn->...vpn', r_om, J)
    Hn = (torch.einsum('...vpn,...vqn->...pqn', J, W)
          - torch.einsum('...pn,...qn->...pqn', dlam * q[..., None, :], dlam))
    if K:
        # Second derivatives of the inputs: d2U/dm_s dt_k = D[k, s]
        # (s != bb), d2(Pb, Nb, U)/dt_d dt_e from the double-difference
        # tables, and d2T/dt_d dt_e = sum_n XN
        X = torch.einsum('...dec,...csn->...desn', wx, corners_ps)
        XN = torch.einsum('...dec,...cn->...den', wx, corners_nb)
        rg = [r * gi for gi in gam]
        mt = torch.einsum('...ksn,...n->...skn', D, rg[2]) * other[:, None,
                                                                  None]
        tt = (X[..., bb_i, :] * rg[0][..., None, None, :]
              + XN * rg[1][..., None, None, :]
              + torch.einsum('...s,...desn->...den', m_other, X)
              * rg[2][..., None, None, :]
              + XN.sum(-1, keepdim=True) * rg[4][..., None, None, :])
        Hn = Hn + torch.cat([
            torch.cat([torch.zeros_like(Hn[..., :S, :S, :]), mt], dim=-2),
            torch.cat([mt.transpose(-2, -3), tt], dim=-2)], dim=-3)
    return ll, g, Hn.sum(-1)


def binned_bb_vgh(corners_ps, corners_nme, m, t, observed, bb_i):
    """Deviance-form LL, gradient and Hessian w.r.t. (m, t) with the
    Beeston-Barlow adjustment of source ``bb_i`` profiled per bin.

    :param corners_ps: (..., 2^K, S, N) pmf corner templates.
    :param corners_nme: (..., 2^K, S, N) MC-count corner templates (only row
      ``bb_i`` is read).
    :param m: (..., S) rates; t: (..., K) lerp weights; observed: (..., N).
    :return: (ll (...), g (..., S+K), H (..., S+K, S+K)); ll excludes the
      saturated-model constant.
    """
    return bb_vgh_from_corners(corners_ps, corners_nme[..., bb_i, :], m, t,
                               observed, bb_i)


def binned_bb_ll(corners_ps, corners_nme, m, t, observed, bb_i):
    """Value-only deviance-form LL with the Beeston-Barlow adjustment (the
    accept-step evaluation inside the Newton loop)."""
    w = corner_weight_tables(t)[0]
    P = torch.einsum('...c,...csn->...sn', w, corners_ps)
    Nb = torch.einsum('...c,...cn->...n', w, corners_nme[..., bb_i, :])
    return bb_ll_from_morphed(P, Nb, m, observed, bb_i)
