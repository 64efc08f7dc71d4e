"""Morphers: interpolate model-valued functions between shape-parameter
anchors.

Counterpart of :mod:`blueice_tpu.morphers`: the :class:`GridInterpolator`
(full cartesian anchor grid, multilinear interpolation), the
:class:`RadialInterpolator` (scattered latin-hypercube anchors,
normalized-exponential distance weights) and :class:`LogMorpher`, geometric
(log) template morphing around either. A morpher builds a dense anchor
tensor once (:meth:`~Morpher.build_tensor`) and evaluates it on the host in
numpy (:meth:`~Morpher.host_eval`) or on a torch tensor
(:meth:`~Morpher.eval`).
"""

import numpy as np
import torch

from .exceptions import NoShapeParameters, InvalidParameterSpecification
from .ops.interp import morph_templates, morph_templates_np
from .utils import arrays_to_grid, combine_dicts, inherit_docstring_from

__all__ = ['Morpher', 'GridInterpolator', 'RadialInterpolator', 'LogMorpher',
           'latin', 'radial_weights', 'MORPHERS']


class Morpher:

    def __init__(self, config, shape_parameters):
        """Initialize the morpher for the given shape parameters.
        :param shape_parameters: OrderedDict setting_name -> (anchors dict
          {z: setting_value}, log_prior, base_value).
        """
        self.config = config
        self.shape_parameters = shape_parameters
        if not len(self.shape_parameters):
            raise NoShapeParameters(
                "Attempt to initialize a morpher without shape parameters")

    def get_anchor_points(self, bounds, n_models=None):
        """List of anchor z-tuples at which models must be built."""
        raise NotImplementedError

    def build_tensor(self, f, extra_dims, anchor_models):
        """Evaluate f at every anchor model and stack into one dense tensor
        whose leading axes index the anchors.
        :param f: function Model -> array of shape extra_dims.
        :param extra_dims: list of ints, shape of f's output.
        :param anchor_models: dict {z-tuple: Model}.
        """
        raise NotImplementedError

    def eval(self, tensor, zs):
        """Torch morph of a stacked anchor ``tensor`` at the point ``zs``."""
        raise NotImplementedError

    def host_eval(self, tensor, zs):
        """Numpy (float64) twin of :meth:`eval`, for the host path."""
        raise NotImplementedError

    def make_interpolator(self, f, extra_dims, anchor_models):
        """A host callable zs -> numpy array interpolating f between the
        anchors (:meth:`build_tensor` once, then :meth:`host_eval`)."""
        tensor = np.asarray(self.build_tensor(f, extra_dims, anchor_models))

        def interpolator(zs):
            return np.asarray(self.host_eval(tensor, np.asarray(zs)))
        return interpolator


class GridInterpolator(Morpher):
    """Full cartesian product of per-parameter anchor values; multilinear
    interpolation between the 2^k surrounding grid corners."""

    @inherit_docstring_from(Morpher)
    def __init__(self, config, shape_parameters):
        super().__init__(config, shape_parameters)
        self.anchor_z_arrays = [
            np.array(sorted(anchors.keys()), dtype=float)
            for setting_name, (anchors, _, _) in shape_parameters.items()]
        for name, arr in zip(shape_parameters, self.anchor_z_arrays):
            if len(arr) < 2:
                raise InvalidParameterSpecification(
                    "Shape parameter %r has %d anchor point(s); grid "
                    "morphing needs at least 2 per axis (to pin a setting, "
                    "put it in the config instead of declaring it a shape "
                    "parameter)" % (name, len(arr)))
        self.anchor_z_grid = arrays_to_grid(self.anchor_z_arrays)

    @inherit_docstring_from(Morpher)
    def get_anchor_points(self, bounds=None, n_models=None):
        grid_shape = self.anchor_z_grid.shape[:-1]
        return [tuple(self.anchor_z_grid[idx])
                for idx in np.ndindex(*grid_shape)]

    @inherit_docstring_from(Morpher)
    def build_tensor(self, f, extra_dims, anchor_models):
        grid_shape = self.anchor_z_grid.shape[:-1]
        tensor = np.zeros(list(grid_shape) + list(extra_dims))
        for idx in np.ndindex(*grid_shape):
            zs = tuple(self.anchor_z_grid[idx])
            tensor[idx] = f(anchor_models[zs])
        return tensor

    @inherit_docstring_from(Morpher)
    def eval(self, tensor, zs):
        return morph_templates(tensor, self.anchor_z_arrays, zs)

    @inherit_docstring_from(Morpher)
    def host_eval(self, tensor, zs):
        return morph_templates_np(tensor, self.anchor_z_arrays, zs)


def radial_weights(zs, normed_anchors, mins, lengths, r_influence):
    """Normalized-exponential weights (n_anchors,) of the scattered anchors
    at the point ``zs`` (k,), on tensors: each anchor's weight decays as
    exp(-r / r_influence) / r_influence with its distance r from the point
    in bounds-normalized coordinates, and the weights sum to 1.

    The squared distance is floored at the dtype's smallest normal before
    the square root: sqrt'(0) is inf, so without the floor every derivative
    at a point exactly on an anchor would be NaN. The tensors' dtype is
    that of ``zs`` and ``normed_anchors`` promoted."""
    dtype = torch.promote_types(zs.dtype, normed_anchors.dtype)
    zs = zs.to(dtype)

    def cast(x):
        return torch.as_tensor(x, dtype=dtype, device=zs.device)
    normed = (zs - cast(mins)) / cast(lengths)
    diffs = cast(normed_anchors) - normed[None, :]
    sumsq = torch.sum(diffs * diffs, dim=-1)
    rs = torch.sqrt(torch.clamp(sumsq, min=torch.finfo(dtype).tiny))
    r_influence = cast(r_influence)
    weights = torch.exp(-rs / r_influence) / r_influence
    return weights / torch.sum(weights)


class RadialInterpolator(Morpher):
    """Scattered-anchor morpher: latin-hypercube anchors inside the shape
    parameters' bounds, normalized-exponential distance weighting. Its
    anchors are random (numpy's global RandomState, :func:`latin`), so
    the compiled likelihood's fits take the autodiff engine (no anchor
    grid for the closed forms)."""

    @inherit_docstring_from(Morpher)
    def __init__(self, config, shape_parameters):
        defaults = dict(r_sample_points=5,
                        hypercube_shuffle_steps=500,
                        decay_response_to_density='constant')
        config = combine_dicts(defaults, config)
        super().__init__(config, shape_parameters)

    @inherit_docstring_from(Morpher)
    def get_anchor_points(self, bounds, n_models=10):
        if n_models is None:
            n_models = 10
        zs_list = latin(n_models, len(self.shape_parameters), box=bounds,
                        shuffle_steps=self.config['hypercube_shuffle_steps'])
        zs_list = list(map(tuple, zs_list))

        bounds = np.array(bounds, dtype=float)
        self._mins = bounds[:, 0]
        self._lengths = bounds[:, 1] - bounds[:, 0]
        self._normed_model_zs = np.array(
            [(np.array(_zs) - self._mins) / self._lengths for _zs in zs_list])

        # Radius of influence: mean distance to the closest sample points
        from scipy.spatial import KDTree
        r0s = KDTree(self._normed_model_zs).query(
            self._normed_model_zs,
            min(self.config['r_sample_points'], len(zs_list)))[0]
        r0s = np.atleast_2d(r0s).reshape(len(zs_list), -1).mean(axis=1)
        decay_response = self.config['decay_response_to_density']
        if decay_response == 'constant':
            r0s = np.ones_like(r0s) * r0s.mean()
        elif decay_response != 'proportional':
            raise NotImplementedError(decay_response)
        self._r0s = r0s

        self._anchor_order = zs_list
        return zs_list

    @property
    def r_influence(self):
        """(n_anchors,) each anchor's decay length: its r0 times the
        config's decay_multiplier (default 5)."""
        return self._r0s * self.config.get('decay_multiplier', 5)

    @inherit_docstring_from(Morpher)
    def build_tensor(self, f, extra_dims, anchor_models):
        return np.array([np.broadcast_to(f(anchor_models[zs]), extra_dims)
                         for zs in self._anchor_order])

    @inherit_docstring_from(Morpher)
    def eval(self, tensor, zs):
        tensor = torch.as_tensor(tensor)
        zs = torch.as_tensor(zs, device=tensor.device)
        if not zs.is_floating_point():
            zs = zs.to(tensor.dtype)
        w = radial_weights(zs.reshape(-1), torch.as_tensor(
            self._normed_model_zs, dtype=tensor.dtype), self._mins,
            self._lengths, self.r_influence)
        dtype = torch.promote_types(w.dtype, tensor.dtype)
        return torch.tensordot(w.to(dtype), tensor.to(dtype), dims=1)

    @inherit_docstring_from(Morpher)
    def host_eval(self, tensor, zs):
        tensor = np.asarray(tensor)
        normed = ((np.asarray(zs, dtype=float).ravel() - self._mins)
                  / self._lengths)
        diffs = self._normed_model_zs - normed[None, :]
        rs = np.sqrt(np.sum(diffs * diffs, axis=-1))
        r_influence = self.r_influence
        weights = np.exp(-rs / r_influence) / r_influence
        weights = weights / weights.sum()
        return np.tensordot(weights, tensor, axes=(0, 0))


class LogMorpher:
    """Positive-definite (geometric) template morphing: wraps a Morpher so
    that anchor templates are combined multiplicatively instead of linearly.

    The anchor tensor is log-transformed at build time; evaluation is
    ``exp(inner_morph(log t))``, rescaled so each template's total mass
    interpolates *linearly* between the anchor masses: rates keep the
    semantics of linear morphing, both factors reduce to the anchor template
    exactly at an anchor, and in between every bin stays strictly positive.

    Zero bins are floored at ``floor`` before the log, so they morph to
    (effectively) zero everywhere. Negative template values are rejected.

    :param inner: the Morpher whose (linear) weights drive the log-space
      combination.
    :param n_template_axes: number of trailing tensor axes that form one
      template (the analysis-space bin axes); the mass rescale sums over
      these. Leading non-anchor axes (e.g. n_sources) are broadcast.
    """

    def __init__(self, inner, n_template_axes, floor=1e-30):
        self.inner = inner
        self.n_template_axes = int(n_template_axes)
        self.floor = float(floor)
        # identity-keyed memo of the per-anchor masses: exp+sum over the
        # full anchor payload runs once per tensor object
        self._mass_memo = {}

    def __getstate__(self):
        state = dict(self.__dict__)
        state['_mass_memo'] = {}     # don't pickle duplicate payloads
        return state

    def get_anchor_points(self, bounds=None, n_models=None):
        return self.inner.get_anchor_points(bounds=bounds, n_models=n_models)

    def build_tensor(self, f, extra_dims, anchor_models):
        t = np.asarray(self.inner.build_tensor(f, extra_dims, anchor_models))
        if np.any(t < 0):
            raise ValueError(
                "log template morphing needs nonnegative templates; the "
                "anchor tensor has negative entries")
        return np.log(np.maximum(t, self.floor))

    def _bin_axes(self, ndim):
        return tuple(range(ndim - self.n_template_axes, ndim))

    def anchor_mass(self, tensor):
        """Per-anchor template masses (sum over the template axes of
        exp(log tensor)), memoized on the tensor's identity."""
        key = id(tensor)
        hit = self._mass_memo.get(key)
        if hit is not None and hit[0] is tensor:
            return hit[1]
        axes = self._bin_axes(tensor.ndim)
        if torch.is_tensor(tensor):
            mass = torch.exp(tensor).sum(dim=axes)
        else:
            mass = np.sum(np.exp(tensor), axis=axes)
        if len(self._mass_memo) >= 4:
            self._mass_memo.clear()
        self._mass_memo[key] = (tensor, mass)
        return mass

    def eval(self, tensor, zs):
        """Torch geometric morph of the log anchor ``tensor`` at ``zs``."""
        raw = torch.exp(self.inner.eval(tensor, zs))
        axes = self._bin_axes(raw.dim())
        if not axes:
            return raw
        mass = self.inner.eval(self.anchor_mass(tensor), zs)
        raw_mass = raw.sum(dim=axes)
        scale = mass / torch.clamp(raw_mass, min=torch.finfo(raw.dtype).tiny)
        return raw * scale[(...,) + (None,) * len(axes)]

    def host_eval(self, tensor, zs):
        """Numpy (float64) twin of :meth:`eval`."""
        tensor = np.asarray(tensor)
        raw = np.exp(np.asarray(self.inner.host_eval(tensor, zs)))
        axes = self._bin_axes(raw.ndim)
        if not axes:
            return raw
        mass = np.asarray(self.inner.host_eval(self.anchor_mass(tensor), zs))
        raw_mass = np.sum(raw, axis=axes)
        scale = mass / np.maximum(raw_mass, np.finfo(float).tiny)
        return raw * scale[(...,) + (None,) * len(axes)]


def latin(n, d, box=None, shuffle_steps=500, rng=None):
    """Latin hypercube of n points in d dimensions, spread-optimized by
    random pairwise coordinate swaps. Each step draws ``randint(n),
    randint(n), randint(d)`` from ``rng`` (default: numpy's global
    RandomState), as the JAX package's does, so one ``np.random.seed``
    gives both the same anchors."""
    if rng is None:
        rng = np.random
    randint = getattr(rng, 'integers', None) or rng.randint
    # Diagonal start
    pts = (np.arange(n, dtype=float) / max(n - 1, 1))[:, None] * np.ones((1, d))

    def spread(p):
        # sum of inverse pairwise distances (lower = better spread)
        diff = p[:, None, :] - p[None, :, :]
        dist = np.sqrt((diff ** 2).sum(-1))
        iu = np.triu_indices(n, k=1)
        return (1.0 / dist[iu]).sum()

    if n > 1:
        best = spread(pts)
        for _ in range(shuffle_steps):
            p1, p2, k = randint(n), randint(n), randint(d)
            newpts = pts.copy()
            newpts[p1, k], newpts[p2, k] = newpts[p2, k], newpts[p1, k]
            s = spread(newpts)
            if s < best:
                pts, best = newpts, s

    if box is None:
        return pts
    for i in range(len(box)):
        pts[:, i] = box[i][0] + pts[:, i] * (box[i][1] - box[i][0])
    return pts


MORPHERS = {x.__name__: x for x in [GridInterpolator, RadialInterpolator]}
