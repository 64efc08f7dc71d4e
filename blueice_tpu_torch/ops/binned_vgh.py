"""Analytic value+gradient+Hessian of the binned Poisson likelihood in the
(morph-weight, rate) parameterization, batched over toys.

Counterpart of :mod:`blueice_tpu.ops.binned_vgh`, with linear and geometric
(log) template morphing (:func:`binned_vgh_log`, :func:`binned_ll_log`:
closed forms that the JAX package too computes outside any kernel). The JAX
functions take one dataset and are vmapped; these take any number of leading batch dimensions
written out (``...`` below), so one call serves a whole toy ensemble, or a
toy ensemble times its line-search candidates.

The morphed template is multilinear in the per-axis lerp weights t and linear
in the per-source rates m, so every derivative of

    ll(m, t) = sum_n [ k_n log(lambda_n / k_n) - (lambda_n - k_n) ],
    lambda_n = sum_s m_s * P_{s,n}(t),
    P(t)     = sum_{c in {0,1}^K} w_c(t) * C_c            (corner templates)

has a closed form in the corner templates; the likelihood curvature follows
from

    g_p    = sum_n r_n dlam/dp,            r = k/lambda - 1
    H_pq   = sum_n [ -q_n dlam/dp dlam/dq + r_n d2lam/dpdq ],  q = k/lambda^2.

This is the plain version of the fused CUDA kernels in
:mod:`blueice_tpu_torch.ops.fused`, and the engine of ``engine='analytic'``.
"""

import itertools

import numpy as np
import torch

__all__ = ['corner_weight_tables', 'binned_vgh', 'binned_ll',
           'binned_vgh_log', 'binned_ll_log', 'log_morph_from_lerp',
           'gather_corners', 'corner_offsets']


def _corner_bits(K, dtype, device):
    """(2^K, K) corner bit table in C order (last axis fastest), made once
    per (K, dtype, device)."""
    key = (K, dtype, torch.device(device))
    if key not in _CORNER_BITS:
        _CORNER_BITS[key] = torch.tensor(
            list(itertools.product((0, 1), repeat=K)), dtype=dtype,
            device=device).reshape(2 ** K, K)
    return _CORNER_BITS[key]


#: (K, dtype, device) -> corner bit table
_CORNER_BITS = {}


def corner_weight_tables(t):
    """Weights of the 2^K corners and their first/second t-derivatives.

    :param t: (..., K) lerp weights in [0, 1].
    :return: (w (..., 2^K), wd (..., K, 2^K), wx (..., K, K, 2^K)) where
      w_c = prod_d (c_d ? t_d : 1-t_d), wd[d] = dw/dt_d, wx[d,e] =
      d2w/dt_d dt_e (zero on the diagonal — multilinearity).
    """
    K = t.shape[-1]
    batch = t.shape[:-1]
    if K == 0:
        return (torch.ones(batch + (1,), dtype=t.dtype, device=t.device),
                torch.zeros(batch + (0, 1), dtype=t.dtype, device=t.device),
                torch.zeros(batch + (0, 0, 1), dtype=t.dtype,
                            device=t.device))
    bits = _corner_bits(K, t.dtype, t.device)                  # (C, K)
    tt = t[..., None, :]                                       # (..., 1, K)
    factors = bits * tt + (1 - bits) * (1.0 - tt)              # (..., C, K)
    signs = 2.0 * bits - 1.0                                   # (C, K)
    eye = torch.eye(K, dtype=torch.bool, device=t.device)
    one = torch.ones((), dtype=t.dtype, device=t.device)

    w = torch.prod(factors, dim=-1)                            # (..., C)
    # wd[d, c] = sign_cd * prod_{d' != d} factor_cd'
    f_d = torch.where(eye[:, None, :], one, factors[..., None, :, :])
    wd = signs.T * torch.prod(f_d, dim=-1)                     # (..., K, C)
    # wx[d, e, c] = sign_cd sign_ce prod_{d' not in {d, e}} factor, 0 on d == e
    skip = eye[:, None, :] | eye[None, :, :]                   # (K, K, K)
    f_de = torch.where(skip[:, :, None, :], one,
                       factors[..., None, None, :, :])         # (..., K, K, C, K)
    wx = (signs.T[:, None, :] * signs.T[None, :, :]
          * torch.prod(f_de, dim=-1))                          # (..., K, K, C)
    wx = torch.where(eye[:, :, None], torch.zeros((), dtype=t.dtype,
                                                  device=t.device), wx)
    return w, wd, wx


def corner_offsets(strides):
    """(2^K,) flattened-grid offsets of a cell's corners for row strides."""
    K = len(strides)
    return [sum(int(c[d]) * int(strides[d]) for d in range(K))
            for c in itertools.product((0, 1), repeat=K)]


def gather_corners(tensor, idx, K):
    """Corner blocks (..., 2^K, *extra) around integer lower-corner indices
    ``idx`` (..., K) from a tensor with K leading anchor axes. Out-of-range
    starts are normalized as ``lax.dynamic_slice`` normalizes them in the
    JAX twin: a negative index gets one +g wrap, then clamps to [0, g-2]."""
    grid_shape = tuple(tensor.shape[:K])
    extra_shape = tuple(tensor.shape[K:])
    G = int(np.prod(grid_shape)) if K else 1
    flat = tensor.reshape((G,) + extra_shape)
    if K == 0:
        return flat.expand(tuple(idx.shape[:-1]) + (1,) + extra_shape)
    gs = torch.as_tensor(grid_shape, device=idx.device)
    idx = torch.where(idx < 0, idx + gs, idx)
    idx = torch.minimum(torch.clamp(idx, min=0), torch.clamp(gs - 2, min=0))
    strides = [int(np.prod(grid_shape[d + 1:], dtype=int)) for d in range(K)]
    base = (idx * torch.as_tensor(strides, device=idx.device)).sum(-1)
    ids = base[..., None] + torch.as_tensor(corner_offsets(strides),
                                            device=idx.device)
    return flat[ids]


def _ll_from_P(P, m, observed):
    """Deviance-form ll (...) from morphed pmfs P (..., S, N)."""
    lam = torch.einsum('...s,...sn->...n', m, P)
    tiny = torch.finfo(P.dtype).tiny
    lam_safe = torch.clamp(lam, min=tiny)
    k_safe = torch.where(observed > 0, observed, torch.ones_like(observed))
    return (torch.sum(observed * torch.log(lam_safe / k_safe)
                      - (lam - observed), dim=-1)
            + 1e6 * torch.sum(torch.clamp(lam, max=0.0), dim=-1))


def binned_vgh(corners, m, t, observed):
    """Deviance-form LL, gradient and Hessian w.r.t. (m, t).

    :param corners: (..., 2^K, S, N) corner templates around the query point
      (flattened over the K anchor axes in C order; K inferred from t).
    :param m: (..., S) per-source expected counts.
    :param t: (..., K) per-axis lerp weights.
    :param observed: (..., N) observed counts.
    :return: (ll (...), g (..., S+K), H (..., S+K, S+K)), parameter order
      [m_1..S, t_1..K]. ll excludes the saturated-model constant (see
      ops.poisson.binned_poisson_logl_constant).
    """
    K = t.shape[-1]
    w, wd, wx = corner_weight_tables(t)
    P = torch.einsum('...c,...csn->...sn', w, corners)
    D = torch.einsum('...kc,...csn->...ksn', wd, corners)
    X = torch.einsum('...kec,...csn->...kesn', wx, corners)
    return _assemble_vgh(P, D, X, m, observed, K)


def _assemble_vgh(P, D, X, m, observed, K):
    """Likelihood value/gradient/Hessian from the morphed templates and their
    t-derivatives.

    :param P: (..., S, N) morphed per-source pmfs at the query point.
    :param D: (..., K, S, N) dP/dt_d.
    :param X: (..., K, K, S, N) d2P/dt_d dt_e.
    """
    dtype = P.dtype
    lam = torch.einsum('...s,...sn->...n', m, P)
    tiny = torch.finfo(dtype).tiny
    lam_safe = torch.clamp(lam, min=tiny)
    k_safe = torch.where(observed > 0, observed, torch.ones_like(observed))

    # Negative-expectation penalty (allow_negative sources): linear in
    # lambda, so its exact contribution rides along in r (d(penalty)/dlam =
    # 1e6 where lam < 0; its own second derivative is 0 a.e.)
    pen_scale = 1e6
    ll = (torch.sum(observed * torch.log(lam_safe / k_safe)
                    - (lam - observed), dim=-1)
          + pen_scale * torch.sum(torch.clamp(lam, max=0.0), dim=-1))
    # Reciprocal form: lam_safe**2 would underflow to 0 for empty bins
    inv_lam = 1.0 / lam_safe
    r = observed * inv_lam - 1.0 + pen_scale * (lam < 0).to(dtype)
    q = (observed * inv_lam) * inv_lam

    g_m = torch.einsum('...sn,...n->...s', P, r)
    Dbar = torch.einsum('...s,...ksn->...kn', m, D)
    g_t = torch.einsum('...kn,...n->...k', Dbar, r)

    H_mm = -torch.einsum('...sn,...n,...zn->...sz', P, q, P)
    if K == 0:
        return ll, g_m, H_mm
    H_mt = (-torch.einsum('...sn,...n,...kn->...sk', P, q, Dbar)
            + torch.einsum('...ksn,...n->...sk', D, r))
    Xbar = torch.einsum('...s,...kesn->...ken', m, X)
    H_tt = (-torch.einsum('...kn,...n,...en->...ke', Dbar, q, Dbar)
            + torch.einsum('...ken,...n->...ke', Xbar, r))
    g = torch.cat([g_m, g_t], dim=-1)
    top = torch.cat([H_mm, H_mt], dim=-1)
    bottom = torch.cat([H_mt.transpose(-1, -2), H_tt], dim=-1)
    return ll, g, torch.cat([top, bottom], dim=-2)


def binned_ll(corners, m, t, observed):
    """Value-only deviance-form LL on corner blocks (..., 2^K, S, N) — the
    cheap accept-step evaluation inside the Newton loop."""
    w = corner_weight_tables(t)[0]
    return _ll_from_P(torch.einsum('...c,...csn->...sn', w, corners),
                      m, observed)


def log_morph_from_lerp(L, M):
    """Morphed pmf P (..., S, N) of the geometric (log) template morph from
    the lerped log templates ``L`` (..., S, N) and the lerped anchor masses
    ``M`` (..., S): raw = exp(L), rescaled so each source's total mass is M
    (raw-mass denominator clamped at the dtype's tiny), as
    :meth:`blueice_tpu_torch.morphers.LogMorpher.eval`. Also returns raw and
    1 / its mass (..., S), which the derivatives need."""
    R = torch.exp(L)
    tiny = torch.finfo(L.dtype).tiny
    inv_mass_raw = 1.0 / torch.clamp(R.sum(-1), min=tiny)
    return R * (M * inv_mass_raw)[..., None], R, inv_mass_raw


def _log_morph_P(log_corners, mass_corners, w):
    """Morphed pmf P of the geometric morph at corner weights w (..., 2^K),
    plus the intermediates its derivatives need.

    :param log_corners: (..., 2^K, S, N) log corner templates.
    :param mass_corners: (..., 2^K, S) per-corner template masses (sum over
      bins of exp(log template), computed on the full template).
    :return: (P (..., S, N), R (..., S, N) raw exp-lerp, inv_mass_raw
      (..., S), M (..., S) lerped target mass).
    """
    L = torch.einsum('...c,...csn->...sn', w, log_corners)
    M = torch.einsum('...c,...cs->...s', w, mass_corners)
    P, R, inv_mass_raw = log_morph_from_lerp(L, M)
    return P, R, inv_mass_raw, M


def binned_vgh_log(log_corners, mass_corners, m, t, observed):
    """:func:`binned_vgh` for geometric (log) template morphing
    (``template_interpolation='log'``): the pmf is exp(multilinear lerp of
    log templates), rescaled to the linearly lerped anchor masses. Same
    contract and parameter order as :func:`binned_vgh`; the t-derivatives
    carry the exp and the mass-rescale quotient chain, so unlike the
    multilinear case d2P/dt_d^2 != 0.

    :param log_corners: (..., 2^K, S, N) log corner templates (the anchor
      tensor a LogMorpher builds).
    :param mass_corners: (..., 2^K, S) per-corner full-template masses.
    """
    K = t.shape[-1]
    w, wd, wx = corner_weight_tables(t)
    P, R, inv_mass_raw, M = _log_morph_P(log_corners, mass_corners, w)
    if K == 0:
        D = P.new_zeros(P.shape[:-2] + (0,) + P.shape[-2:])
        X = P.new_zeros(P.shape[:-2] + (0, 0) + P.shape[-2:])
        return _assemble_vgh(P, D, X, m, observed, K)

    tiny = torch.finfo(P.dtype).tiny
    Ld = torch.einsum('...kc,...csn->...ksn', wd, log_corners)    # (K, S, N)
    Lx = torch.einsum('...kec,...csn->...kesn', wx, log_corners)  # (K, K, S, N)
    Md = torch.einsum('...kc,...cs->...ks', wd, mass_corners)     # (K, S)
    Mx = torch.einsum('...kec,...cs->...kes', wx, mass_corners)   # (K, K, S)
    inv_M = 1.0 / torch.clamp(M, min=tiny)

    # Raw-mass derivatives: A_d = d(sum R)/dt_d, B_de = d2(sum R)/dt_d dt_e
    A = torch.einsum('...sn,...ksn->...ks', R, Ld)
    B = (torch.einsum('...sn,...ksn,...esn->...kes', R, Ld, Ld)
         + torch.einsum('...sn,...kesn->...kes', R, Lx))

    # log-scale chain: scale = M / mass_raw, v_d = d log(scale)/dt_d,
    # w_de = d2 log(scale)/dt_d dt_e
    Mn = Md * inv_M[..., None, :]
    An = A * inv_mass_raw[..., None, :]
    v = Mn - An                                                   # (K, S)
    w2 = (Mx * inv_M[..., None, None, :]
          - Mn[..., :, None, :] * Mn[..., None, :, :]
          - B * inv_mass_raw[..., None, None, :]
          + An[..., :, None, :] * An[..., None, :, :])            # (K, K, S)

    # dP/dt_d = P u_d with u_d = Ld + v_d; d2P = P (u_d u_e + Lx + w_de)
    u = Ld + v[..., None]                                         # (K, S, N)
    D = P[..., None, :, :] * u
    X = P[..., None, None, :, :] * (u[..., :, None, :, :]
                                    * u[..., None, :, :, :]
                                    + Lx + w2[..., None])         # (K, K, S, N)
    return _assemble_vgh(P, D, X, m, observed, K)


def binned_ll_log(log_corners, mass_corners, m, t, observed):
    """Value-only twin of :func:`binned_vgh_log` (the cheap accept-step
    evaluation inside the Newton loop)."""
    w = corner_weight_tables(t)[0]
    return _ll_from_P(_log_morph_P(log_corners, mass_corners, w)[0], m,
                      observed)
