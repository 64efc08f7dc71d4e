"""Grid and 1D-interpolation helpers.

Role parity with the reference's grid utilities
(reference: blueice/utils.py:104-153). ``InterpolateAndExtrapolate1D`` here returns
a true scalar for scalar input (the reference's ``give_scalar`` flag was never set,
a latent bug at blueice/utils.py:134-137 we do not reproduce).
"""

import numpy as np

__all__ = ['arrays_to_grid', 'events_to_analysis_dimensions',
           'InterpolateAndExtrapolate1D']


def arrays_to_grid(arrs):
    """Convert a list of n 1-dim arrays to an (n+1)-dim array, where the last
    dimension holds the coordinate values at each grid point."""
    return np.stack(np.meshgrid(*arrs, indexing='ij'), axis=-1)


def events_to_analysis_dimensions(events, analysis_space):
    """Return a list of arrays: the values of events in each analysis dimension.

    ``events`` must be indexable by dimension name (numpy record array, pandas
    DataFrame, or dict of arrays).
    """
    return [np.asarray(events[x]) for x, bins in analysis_space]


class InterpolateAndExtrapolate1D:
    """Linear 1D interpolation with constant extrapolation outside the data range.

    Accepts scalar or array input; scalar input returns a scalar.
    """

    def __init__(self, points, values):
        points = np.atleast_1d(np.asarray(points, dtype=float))
        values = np.atleast_1d(np.asarray(values, dtype=float))
        if len(points) != len(values):
            raise ValueError("points and values must have equal length")
        order = np.argsort(points)
        self.points = points[order]
        self.values = values[order]
        self.min = self.points.min()
        self.max = self.points.max()

    def __call__(self, x):
        scalar = np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)
        xs = np.atleast_1d(np.asarray(x, dtype=float))
        xs = np.clip(xs, self.min, self.max)
        if len(self.points) == 1:
            result = np.full(xs.shape, self.values[0])
        else:
            result = np.interp(xs, self.points, self.values)
        return result[0] if scalar else result
