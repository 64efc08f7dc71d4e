"""Morphers: interpolate model-valued functions between shape-parameter
anchors.

Counterpart of :mod:`blueice_tpu.morphers` for the slice the port runs: the
:class:`GridInterpolator` (full cartesian anchor grid, multilinear
interpolation) and :class:`LogMorpher`, geometric (log) template morphing
around it. A morpher builds a dense anchor tensor once
(:meth:`~GridInterpolator.build_tensor`) and evaluates it on the host in
numpy (:meth:`~GridInterpolator.host_eval`) or on a torch tensor
(:meth:`~GridInterpolator.eval`).
"""

import numpy as np
import torch

from .exceptions import NoShapeParameters, InvalidParameterSpecification
from .ops.interp import morph_templates, morph_templates_np
from .utils import arrays_to_grid, inherit_docstring_from

__all__ = ['Morpher', 'GridInterpolator', 'LogMorpher', 'MORPHERS']


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


MORPHERS = {x.__name__: x for x in [GridInterpolator]}
