"""Dense N-dimensional histograms over the analysis space.

This replaces the reference's ``multihist.Histdd`` dependency (used at reference
blueice/source.py:24,287 and blueice/likelihood.py:11,608) with a small host-side
class whose payload is a plain numpy array — the natural feed for device-resident
template tensors. Filling goes through the native C++ filler
(:mod:`blueice_tpu_torch.native`), with ``numpy.histogramdd``'s semantics.
"""

from functools import reduce

import numpy as np

__all__ = ['Hist']


class Hist:
    """A dense N-dim histogram: bin ``edges`` per axis plus a values array.

    Covers the multihist.Histdd surface the framework needs: ``add``, ``lookup``,
    ``bin_centers``, ``bin_volumes``, ``get_random``, ``similar_blank``, ``n``,
    scalar/array multiplication.
    """

    def __init__(self, edges, axis_names=None, values=None):
        self.edges = tuple(np.asarray(e, dtype=float) for e in edges)
        for e in self.edges:
            if e.ndim != 1 or len(e) < 2:
                raise ValueError("Each axis needs at least two bin edges")
        self.axis_names = tuple(axis_names) if axis_names is not None else None
        shape = tuple(len(e) - 1 for e in self.edges)
        if values is None:
            self.values = np.zeros(shape, dtype=float)
        else:
            values = np.asarray(values, dtype=float)
            if values.shape != shape:
                raise ValueError("values shape %s does not match edges shape %s"
                                 % (values.shape, shape))
            self.values = values

    # -- construction ------------------------------------------------------

    @classmethod
    def from_analysis_space(cls, analysis_space):
        """Build an empty histogram from [[dim_name, bin_edges], ...]."""
        names, edges = zip(*analysis_space)
        return cls(edges, axis_names=names)

    def similar_blank(self):
        """A zero-valued histogram with the same binning."""
        return Hist(self.edges, axis_names=self.axis_names)

    def copy(self):
        return Hist(self.edges, axis_names=self.axis_names, values=self.values.copy())

    # -- properties --------------------------------------------------------

    @property
    def ndim(self):
        return len(self.edges)

    @property
    def shape(self):
        return self.values.shape

    @property
    def n(self):
        """Total (weighted) number of entries."""
        return self.values.sum()

    def bin_centers(self, axis=None):
        if axis is None:
            return [0.5 * (e[1:] + e[:-1]) for e in self.edges]
        e = self.edges[axis]
        return 0.5 * (e[1:] + e[:-1])

    def bin_volumes(self):
        """Outer product of bin widths: array of shape self.shape."""
        return reduce(np.multiply, np.ix_(*[np.diff(e) for e in self.edges]))

    # -- filling and lookup --------------------------------------------------

    def add(self, *coordinate_arrays, weights=None):
        """Histogram the given per-axis coordinate arrays into this histogram
        (native C++ accumulation when available, numpy otherwise; both with
        numpy.histogramdd semantics)."""
        if len(coordinate_arrays) != self.ndim:
            raise ValueError("Need %d coordinate arrays, got %d"
                             % (self.ndim, len(coordinate_arrays)))
        from ..native import histogram_nd
        sample = np.stack([np.asarray(c, dtype=float) for c in coordinate_arrays],
                          axis=-1)
        self.values += histogram_nd(sample, self.edges, weights=weights)
        return self

    def bin_indices(self, *coordinate_arrays):
        """Per-axis bin indices of the given coordinates, clipped into range.

        Consistent with numpy.histogramdd: left-edge inclusive, and the last bin
        also includes its right edge.
        """
        idx = []
        for e, x in zip(self.edges, coordinate_arrays):
            i = np.searchsorted(e, np.asarray(x, dtype=float), side='right') - 1
            idx.append(np.clip(i, 0, len(e) - 2))
        return tuple(idx)

    def lookup(self, *coordinate_arrays):
        """Piecewise-constant lookup: histogram value of the bin containing each
        coordinate (out-of-range coordinates clip to the nearest bin)."""
        return self.values[self.bin_indices(*coordinate_arrays)]

    # -- sampling ------------------------------------------------------------

    def get_random(self, n, rng=None):
        """Sample n points: bins weighted by histogram value, uniform within a bin.
        Returns an array of shape (n, ndim)."""
        if rng is None:
            rng = np.random.default_rng()
        elif isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(rng)
        n = int(n)
        flat = self.values.reshape(-1).astype(float)
        total = flat.sum()
        if total <= 0:
            raise ValueError("Cannot sample from an empty histogram")
        bin_i = rng.choice(len(flat), size=n, p=flat / total)
        multi = np.unravel_index(bin_i, self.shape)
        out = np.empty((n, self.ndim), dtype=float)
        for d, (e, idx) in enumerate(zip(self.edges, multi)):
            lo = e[idx]
            hi = e[idx + 1]
            out[:, d] = lo + rng.random(n) * (hi - lo)
        return out

    # -- arithmetic ----------------------------------------------------------

    def __mul__(self, other):
        other_values = other.values if isinstance(other, Hist) else np.asarray(other)
        return Hist(self.edges, axis_names=self.axis_names,
                    values=self.values * other_values)

    __rmul__ = __mul__

    def __truediv__(self, other):
        other_values = other.values if isinstance(other, Hist) else np.asarray(other)
        return Hist(self.edges, axis_names=self.axis_names,
                    values=self.values / other_values)

    def __repr__(self):
        return "Hist(shape=%s, n=%s)" % (self.shape, self.n)
