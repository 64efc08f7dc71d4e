"""Multilinear interpolation over anchor grids: the numpy host twins and the
torch device functions.

Counterpart of :mod:`blueice_tpu.ops.interp`. The numpy functions
(:func:`morph_templates_np`, :func:`interp_at_points_np`) are the host path of
the morphers and of ``HistogramPdfSource.pdf``; :func:`morph_weights` and
:func:`morph_templates` are the torch twins of the JAX functions of the same
names. :func:`clip` is ``jnp.clip`` written as JAX writes it
(``minimum(maximum(x, lo), hi)``), so its derivative at a bound is the same
half-slope JAX gives — the fitter differentiates through it, and an optimum
sitting exactly on an anchor is common.
"""

import itertools

import numpy as np
import torch

__all__ = ['clip', 'morph_weights', 'morph_templates', 'morph_templates_np',
           'interp_at_points_np']


def clip(x, lo, hi):
    """``jnp.clip`` with JAX's derivative convention at ties (0.5, from
    ``maximum``/``minimum``), where ``torch.clamp`` would give 1."""
    x = torch.as_tensor(x)

    def bound(b):
        # a Python number is filled on the device, not copied from the host
        if isinstance(b, (int, float)):
            return x.new_full((), b)
        return torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def cell_index(arr, z):
    """Lower anchor-cell index of ``z`` on the sorted 1-d anchor tensor
    ``arr``: ``clip(searchsorted(arr, z, side='right') - 1, 0, len - 2)``.
    Piecewise constant in z (its derivative is zero), so callers compute it
    outside any differentiated function."""
    flat = z.reshape(-1).contiguous()
    i = torch.searchsorted(arr, flat, right=True) - 1
    return torch.clamp(i, 0, arr.shape[0] - 2).reshape(z.shape)


def morph_weights(anchor_arrays, zs):
    """Per-axis lower corner indices and lerp weights for query points.

    :param anchor_arrays: k sorted 1-d anchor arrays (each of length >= 2).
    :param zs: (..., k) tensor of query coordinates (clamped into range).
    :return: (idx, ts): lists of k index tensors and k weight tensors in
      [0, 1], each of shape ``zs.shape[:-1]``.
    """
    idx, ts = [], []
    for d, arr in enumerate(anchor_arrays):
        arr = (arr if torch.is_tensor(arr) else torch.as_tensor(
            np.asarray(arr))).to(dtype=zs.dtype, device=zs.device)
        z = zs[..., d]
        i = cell_index(arr, z)
        x0 = arr[i]
        x1 = arr[i + 1]
        idx.append(i)
        ts.append(clip((z - x0) / (x1 - x0), 0.0, 1.0))
    return idx, ts


def morph_templates(tensor, anchor_arrays, zs):
    """Multilinear interpolation of ``tensor`` over its leading anchor-grid
    axes at one point ``zs`` ((k,) tensor): reads the 2^k corner templates
    and lerps axis by axis, ``(1 - t) * a + t * b``, as the JAX twin does
    (exact at anchor points).

    :param tensor: (n_1, ..., n_k, *extra) payload stacked over the grid.
    :return: tensor of shape ``extra``.
    """
    k = len(anchor_arrays)
    if k == 0:
        return tensor
    idx, ts = morph_weights(anchor_arrays, zs)
    corner = tensor
    for d in range(k):
        corner = corner.index_select(d, torch.stack([idx[d], idx[d] + 1]))
    for t in ts:
        t = t.to(corner.dtype)
        corner = (1.0 - t) * corner[0] + t * corner[1]
    return corner


def morph_templates_np(tensor, anchor_arrays, zs):
    """Numpy twin of :func:`morph_templates` — identical multilinear math in
    float64 on the host (the morphers' host path)."""
    tensor = np.asarray(tensor)
    k = len(anchor_arrays)
    if k == 0:
        return tensor
    zs = np.asarray(zs, dtype=float).ravel()
    slices = []
    ts = []
    for d, arr in enumerate(anchor_arrays):
        arr = np.asarray(arr, dtype=float)
        i = int(np.clip(np.searchsorted(arr, zs[d], side='right') - 1,
                        0, len(arr) - 2))
        t = np.clip((zs[d] - arr[i]) / (arr[i + 1] - arr[i]), 0.0, 1.0)
        slices.append(slice(i, i + 2))
        ts.append(t)
    corner = tensor[tuple(slices)]
    for t in ts:
        corner = (1.0 - t) * corner[0] + t * corner[1]
    return corner


def interp_at_points_np(values, points, coords):
    """Multilinear interpolation of a gridded field at many query points
    (host path, float64). Coordinates outside the grid clip to its range
    (the reference's clip-to-bin-center rule, blueice/source.py:234-240).

    :param values: (n_1, ..., n_k) field values on the grid.
    :param points: k sorted 1-d coordinate arrays.
    :param coords: (m, k) query coordinates.
    :return: (m,) interpolated values.
    """
    values = np.asarray(values)
    coords = np.asarray(coords, dtype=float)
    if coords.ndim == 1:
        coords = coords[:, None]
    k = len(points)
    idx, ts = [], []
    for d in range(k):
        p = np.asarray(points[d], dtype=float)
        n = len(p)
        if n == 1:
            idx.append(np.zeros(coords.shape[0], dtype=int))
            ts.append(np.zeros(coords.shape[0]))
            continue
        x = np.clip(coords[:, d], p[0], p[-1])
        i = np.clip(np.searchsorted(p, x, side='right') - 1, 0, n - 2)
        ts.append((x - p[i]) / (p[i + 1] - p[i]))
        idx.append(i)
    if any(len(np.asarray(p)) == 1 for p in points):
        pad = [(0, 1) if len(np.asarray(p)) == 1 else (0, 0) for p in points]
        values = np.pad(values, pad, mode='edge')
    out = np.zeros(coords.shape[0])
    for offsets in itertools.product((0, 1), repeat=k):
        w = np.ones(coords.shape[0])
        gather_idx = []
        for d, o in enumerate(offsets):
            w = w * (ts[d] if o else (1.0 - ts[d]))
            gather_idx.append(idx[d] + o)
        out += w * values[tuple(gather_idx)]
    return out
