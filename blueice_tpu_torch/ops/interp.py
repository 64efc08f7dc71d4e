"""Multilinear interpolation over anchor grids: the numpy host twins and the
torch device functions.

Counterpart of :mod:`blueice_tpu.ops.interp`. The numpy functions
(:func:`morph_templates_np`, :func:`interp_at_points_np`) are the host path of
the morphers and of ``HistogramPdfSource.pdf``; :func:`morph_weights`,
:func:`morph_templates`, :func:`interp_at_points` and
:func:`piecewise_lookup` are the torch twins of the JAX functions of the
same names (the last two take fields with leading dimensions: the unbinned
study scores every template row at once). :func:`clip` is ``jnp.clip`` written as JAX writes it
(``minimum(maximum(x, lo), hi)``), so its derivative at a bound is the same
half-slope JAX gives — the fitter differentiates through it, and an optimum
sitting exactly on an anchor is common.
"""

import itertools

import numpy as np
import torch

__all__ = ['clip', 'morph_weights', 'morph_templates', 'cell_rows',
           'corner_weights', 'morph_rows', 'morph_templates_np',
           'interp_at_points', 'piecewise_lookup', 'interp_at_points_np']


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
        # index with a 1-d tensor: a 0-d index would read a Python int,
        # which torch.func's vmap cannot batch
        x0 = arr[i.reshape(-1)].reshape(i.shape)
        x1 = arr[(i + 1).reshape(-1)].reshape(i.shape)
        idx.append(i)
        ts.append(clip((z - x0) / (x1 - x0), 0.0, 1.0))
    return idx, ts


_OFFSETS = {}


def grid_strides(grid):
    """Row-major strides of a flattened anchor grid of shape ``grid``."""
    return [int(np.prod(grid[d + 1:])) for d in range(len(grid))]


def corner_offsets(strides, device):
    """(2^k,) flat-row offsets of a cell's corners from its lower corner,
    made once per grid and device (a copy from host memory at every call
    would wait for the device). Make them before a ``torch.func``
    transform first morphs on the grid: a tensor made inside one belongs
    to it and cannot be reused outside."""
    key = (tuple(strides), str(device))
    if key not in _OFFSETS:
        _OFFSETS[key] = torch.as_tensor(
            [sum(o * st for o, st in zip(offs, strides))
             for offs in itertools.product((0, 1), repeat=len(strides))],
            dtype=torch.int64, device=device)
    return _OFFSETS[key]


def morph_templates(tensor, anchor_arrays, zs):
    """Multilinear interpolation of ``tensor`` over its leading anchor-grid
    axes at one point ``zs`` ((k,) tensor): the 2^k corner templates of
    the point's cell, weighted by the products of the per-axis lerp
    weights (exact at anchor points; the JAX twin lerps axis by axis,
    the same function to rounding).

    :param tensor: (n_1, ..., n_k, *extra) payload stacked over the grid.
    :return: tensor of shape ``extra``.
    """
    k = len(anchor_arrays)
    if k == 0:
        return tensor
    idx, ts = morph_weights(anchor_arrays, zs)
    rows = cell_rows(idx, tensor.shape[:k], tensor.device)
    return morph_rows(tensor, k, rows, corner_weights(ts))


def cell_rows(idx, grid, device):
    """(2^k,) flat rows of the corners of the cell whose lower corner has
    the per-axis indices ``idx`` on a grid of shape ``grid`` (axis 0 most
    significant)."""
    strides = grid_strides(grid)
    base = sum(i * st for i, st in zip(idx, strides)).reshape(1)
    return base + corner_offsets(strides, device)


def corner_weights(ts):
    """(2^k,) multilinear weights of a cell's corners, in the order of
    :func:`cell_rows`, from the per-axis lerp weights ``ts``."""
    w = None
    for t in ts:
        pair = torch.stack([1.0 - t, t])
        w = pair if w is None else (w[:, None] * pair[None, :]).reshape(-1)
    return w


def morph_rows(tensor, k, rows, weights):
    """The weighted sum of the corner ``rows`` (:func:`cell_rows`) of a
    payload stacked over a k-axis grid (n_1, ..., n_k, *extra): one gather
    and one contraction, so a batch of points under ``torch.func``'s vmap
    reads 2^k rows a point; in the wider of the two dtypes (float64
    weights morph a float32 payload in float64)."""
    extra = tensor.shape[k:]
    corners = tensor.reshape((-1,) + extra)[rows]
    dtype = torch.promote_types(weights.dtype, corners.dtype)
    return torch.tensordot(weights.to(dtype), corners.to(dtype), dims=1)


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


def interp_at_points(values, points, coords):
    """Multilinear interpolation of gridded fields at many query points.

    :param values: (*lead, n_1, ..., n_k) field values on the grid (any
      leading dimensions: one field a leading index).
    :param points: k sorted 1-d coordinate arrays (len n_i).
    :param coords: (m, k) query coordinates. Coordinates outside the grid
      are clipped to its range (constant extrapolation: the reference's
      clip-to-bin-center rule, blueice/source.py:234-240).
    :return: (*lead, m) interpolated values.
    """
    coords = torch.as_tensor(coords)
    if coords.dim() == 1:
        coords = coords[:, None]
    k = len(points)
    m = coords.shape[0]
    idx, ts = [], []
    for d in range(k):
        p = torch.as_tensor(np.asarray(points[d]) if not torch.is_tensor(
            points[d]) else points[d], dtype=coords.dtype,
            device=coords.device)
        n = p.shape[0]
        if n == 1:
            idx.append(torch.zeros(m, dtype=torch.int64,
                                   device=coords.device))
            ts.append(torch.zeros(m, dtype=values.dtype,
                                  device=coords.device))
            continue
        x = torch.clamp(coords[:, d], p[0], p[-1])
        i = torch.clamp(torch.searchsorted(p, x.contiguous(), right=True) - 1,
                        0, n - 2)
        idx.append(i)
        ts.append(((x - p[i]) / (p[i + 1] - p[i])).to(values.dtype))
    # Single-point axes repeat their one value, so i + 1 stays in range
    for d in range(k):
        if len(points[d]) == 1:
            axis = values.dim() - k + d
            values = torch.cat([values, values.narrow(axis, 0, 1)], axis)
    out = None
    for offsets in itertools.product((0, 1), repeat=k):
        w = torch.ones(m, dtype=values.dtype, device=values.device)
        for d, o in enumerate(offsets):
            w = w * (ts[d] if o else (1.0 - ts[d]))
        term = w * values[(Ellipsis,) + tuple(i + o for i, o
                                              in zip(idx, offsets))]
        out = term if out is None else out + term
    return out


def piecewise_lookup(values, edges, coords):
    """Piecewise-constant (bin) lookup of histogram payloads at query
    points.

    :param values: (*lead, n_1-1, ..., n_k-1) per-bin values.
    :param edges: k sorted 1-d bin-edge arrays (len n_i).
    :param coords: (m, k) query coordinates; out-of-range clips to the
      nearest bin.
    :return: (*lead, m) bin values. Left-edge inclusive; the last bin
      includes its right edge (numpy.histogramdd convention).
    """
    coords = torch.as_tensor(coords)
    if coords.dim() == 1:
        coords = coords[:, None]
    gather = []
    for d, e in enumerate(edges):
        e = torch.as_tensor(np.asarray(e) if not torch.is_tensor(e) else e,
                            dtype=coords.dtype, device=coords.device)
        i = torch.searchsorted(e, coords[:, d].contiguous(), right=True) - 1
        gather.append(torch.clamp(i, 0, e.shape[0] - 2))
    return values[(Ellipsis,) + tuple(gather)]


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
