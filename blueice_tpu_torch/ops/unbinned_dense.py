"""Dense (matrix-product) forms of the closed-form unbinned engine.

Counterpart of :mod:`blueice_tpu.ops.unbinned_dense`. No corner block is
gathered: every morph target is a row of one stacked product against the
toy's flattened anchor tensor.

* vgh: the J = 1 + K + K(K-1)/2 (value / d/dt_k / d2/dt_d dt_e) corner
  weight tables are put onto the full G axis through one-hot rows (a
  (J, C) x (C, G) product) and applied as one (J, G) x (G, S*E) product.
* value at A candidates: the combined coefficients ``coeff[a, g, s] =
  wfull[a, g] * m[a, s]`` make the A rate densities one (A, G*S) x
  (G*S, E) product.

The JAX package computes these products outside any Pallas kernel, so the
port computes them with ``torch.bmm`` (float32 with TF32 off on the card,
see :func:`blueice_tpu_torch.device.resolve`); no kernel is written for
them. Each function takes either one toy, as the JAX functions do (``ps``
(G, S, E)), or a batch of lanes (``ps`` (B, G, S, E) with ``lanes`` (L,),
the toys of the lanes, read as ``ps[lanes]``; without ``lanes`` every
toy, one lane each), the way the port's other unbinned ops read the
per-toy tensor. The fitter takes this engine only through its test hook
``parallel.fitter._FORCE_DENSE_UNBINNED``.
"""

import torch

from .binned_vgh import corner_weight_tables
from .fused import corner_ids

__all__ = ['unbinned_vgh_dense', 'unbinned_ll_dense_many']


def _onehot_rows(ids, G, dtype):
    """(..., C) int ids -> (..., C, G) 0/1 rows."""
    return (torch.arange(G, device=ids.device) == ids[..., None]).to(dtype)


def _pair_table(K, dtype, device):
    """(NP, K, K) 0/1 table putting the NP = K(K-1)/2 cross terms at (d, e)
    and (e, d), d < e; made once per (K, dtype, device)."""
    key = (K, dtype, torch.device(device))
    if key not in _PAIR_TABLES:
        pairs = [(d, e) for d in range(K) for e in range(d + 1, K)]
        table = torch.zeros((len(pairs), K, K), dtype=dtype)
        for p, (d, e) in enumerate(pairs):
            table[p, d, e] = table[p, e, d] = 1.0
        _PAIR_TABLES[key] = table.to(device)
    return _PAIR_TABLES[key]


#: (K, dtype, device) -> cross-term table
_PAIR_TABLES = {}


def _batch(ps, lanes, per_lane, per_toy):
    """(ps (B, G, S, E), lanes or None, per-lane args with a lane axis,
    per-toy args (B, E) or None, whether the call is one toy)."""
    per_lane = [torch.as_tensor(a, device=ps.device) for a in per_lane]
    single = ps.dim() == 3
    if single:
        ps = ps[None]
        per_lane = [a[None] for a in per_lane]
        per_toy = [None if a is None else a[None] for a in per_toy]
    return ps, lanes, per_lane, per_toy, single


def _rows(ps, lanes):
    """(L, G, S, E) densities of the lanes' toys."""
    return ps if lanes is None else ps[lanes]


def _ref(ref_msum, ps):
    """``ref_msum`` as a tensor of the densities' dtype and device."""
    return torch.as_tensor(ref_msum, dtype=ps.dtype, device=ps.device)


def _log_term(lam, mask, outlier_likelihood, inv_ref):
    """sum_e mask_e log(lam_eff_e [* inv_ref_e]) over the last axis."""
    lam_eff = (torch.where(lam > 0, lam,
                           torch.full_like(lam, outlier_likelihood))
               if outlier_likelihood != 0 else lam)
    if inv_ref is not None:
        lam_eff = lam_eff * inv_ref
    return torch.sum(torch.where(mask, torch.log(lam_eff),
                                 torch.zeros_like(lam_eff)), dim=-1)


def unbinned_vgh_dense(ps, strides, idx, t, m, mask, outlier_likelihood=0.0,
                       inv_ref=None, ref_msum=0.0, lanes=None):
    """Extended-LL (value, gradient, Hessian) w.r.t. (m, t), the corner
    combine as one stacked product over the full anchor grid.

    Same contract and closed forms as
    :func:`blueice_tpu_torch.ops.unbinned_vgh.unbinned_vgh`, on the toy's
    whole flattened-grid tensor.

    :param ps: (G, S, E) one toy's per-event densities at every
      (flattened) anchor, or (B, G, S, E) a batch of toys.
    :param strides: K ints — anchor-grid row strides.
    :param idx: (K,) or (L, K) integer lower corners (pre-clipped by the
      caller, as for gather_corners).
    :param t: (K,) or (L, K) lerp weights; m: (S,) or (L, S) rates.
    :param mask: (E,) or (B, E) event validity.
    :param inv_ref, ref_msum: optional centering (``inv_ref`` (E,) or
      (B, E), ``ref_msum`` () or (L,); see
      :func:`blueice_tpu_torch.ops.unbinned_vgh.reference_center`).
    :param lanes: with a batch, (L,) int64 toys of the lanes (None: every
      toy, one lane each).
    :return: (ll, g (S+K,), H (S+K, S+K)), each with a leading lane axis
      (L,) for a batch.
    """
    ps, lanes, (idx, t, m), (mask, inv_ref), single = _batch(
        ps, lanes, [idx, t, m], [mask, inv_ref])
    B, G, S, E = ps.shape
    dt = ps.dtype
    t = t.to(dt)
    m = m.to(dt)
    L, K = t.shape
    NP = K * (K - 1) // 2
    if lanes is not None:
        mask = mask[lanes]
        inv_ref = None if inv_ref is None else inv_ref[lanes]

    ids = corner_ids(strides, idx, G)                             # (L, C)
    w, wd, wx = corner_weight_tables(t)
    iu = torch.triu_indices(K, K, 1, device=ps.device)
    Wc = torch.cat([w[:, None], wd, wx[:, iu[0], iu[1]]], dim=1)  # (L, J, C)
    Wt = torch.bmm(Wc, _onehot_rows(ids, G, dt))                  # (L, J, G)
    morphs = torch.bmm(Wt, _rows(ps, lanes).reshape(L, G, S * E)
                       ).reshape(L, -1, S, E)                     # (L, J, S, E)
    P = morphs[:, 0]
    D = morphs[:, 1:1 + K]                                        # (L, K, S, E)
    Xp = morphs[:, 1 + K:]                                        # (L, NP, S, E)

    lam = torch.einsum('ls,lse->le', m, P)
    msum = m.sum(-1)
    log_term = _log_term(lam, mask, outlier_likelihood, inv_ref)
    ll = (-msum + log_term if inv_ref is None
          else -(msum - _ref(ref_msum, ps)) + log_term)

    pos = lam > 0
    lam_safe = torch.where(pos, lam, torch.ones_like(lam))
    inv_lam = (mask & pos).to(dt) / lam_safe
    q = inv_lam / lam_safe

    g_m = torch.einsum('lse,le->ls', P, inv_lam) - 1.0
    Dbar = torch.einsum('ls,lkse->lke', m, D)
    g_t = torch.einsum('lke,le->lk', Dbar, inv_lam)
    Pq = P * q[:, None]
    H_mm = -torch.einsum('lse,lze->lsz', Pq, P)
    H_mt = (-torch.einsum('lse,lke->lsk', Pq, Dbar)
            + torch.einsum('lkse,le->lsk', D, inv_lam))
    H_tt = -torch.einsum('lke,lze->lkz', Dbar * q[:, None], Dbar)
    if NP:
        xr = torch.einsum('ls,lpse,le->lp', m, Xp, inv_lam)
        H_tt = H_tt + torch.einsum('lp,pkz->lkz', xr,
                                   _pair_table(K, dt, ps.device))
    g = torch.cat([g_m, g_t], dim=-1)
    H = torch.cat([torch.cat([H_mm, H_mt], dim=-1),
                   torch.cat([H_mt.transpose(1, 2), H_tt], dim=-1)], dim=-2)
    if single:
        return ll[0], g[0], H[0]
    return ll, g, H


def unbinned_ll_dense_many(ps, strides, idxs, ts, ms, mask,
                           outlier_likelihood=0.0, inv_ref=None,
                           ref_msum=0.0, lanes=None):
    """Extended LL at A parameter candidates sharing one toy's events — one
    (A, G*S) x (G*S, E) product a lane, no corner block.

    :param ps: (G, S, E) flattened-grid densities, or (B, G, S, E).
    :param idxs: (A, K) or (L, A, K) integer lower corners; ts: (A, K) or
      (L, A, K); ms: (A, S) or (L, A, S).
    :param mask, inv_ref, ref_msum, lanes: as for
      :func:`unbinned_vgh_dense` (``ref_msum`` () or (L,), one a lane, or
      (L, A) / (L, 1)).
    :return: (A,) or (L, A) log likelihoods (centered with ``inv_ref``).
    """
    ps, lanes, (idxs, ts, ms), (mask, inv_ref), single = _batch(
        ps, lanes, [idxs, ts, ms], [mask, inv_ref])
    B, G, S, E = ps.shape
    dt = ps.dtype
    ts = ts.to(dt)
    ms = ms.to(dt)
    L, A = ms.shape[:2]
    if lanes is not None:
        mask = mask[lanes]
        inv_ref = None if inv_ref is None else inv_ref[lanes]

    ids = corner_ids(strides, idxs, G)                            # (L, A, C)
    w = corner_weight_tables(ts)[0].to(dt)                        # (L, A, C)
    wfull = torch.einsum('lac,lacg->lag', w, _onehot_rows(ids, G, dt))
    coeff = (wfull[..., None] * ms[:, :, None, :]).reshape(L, A, G * S)
    lam = torch.bmm(coeff, _rows(ps, lanes).reshape(L, G * S, E))  # (L, A, E)
    msum = ms.sum(-1)
    log_term = _log_term(lam, mask[:, None], outlier_likelihood,
                         None if inv_ref is None else inv_ref[:, None])
    if inv_ref is None:
        out = -msum + log_term
    else:
        ref = _ref(ref_msum, ps)
        out = -(msum - (ref[:, None] if ref.dim() == 1 else ref)) + log_term
    return out[0] if single else out
