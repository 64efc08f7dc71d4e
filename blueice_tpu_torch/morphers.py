"""Morphers: interpolate model-valued functions between shape-parameter
anchors.

Counterpart of :mod:`blueice_tpu.morphers` for the slice the port runs: the
:class:`GridInterpolator` (full cartesian anchor grid, multilinear
interpolation). A morpher builds a dense anchor tensor once
(:meth:`~GridInterpolator.build_tensor`) and evaluates it on the host in
numpy (:meth:`~GridInterpolator.host_eval`) or on a torch tensor
(:meth:`~GridInterpolator.eval`).
"""

import numpy as np

from .exceptions import NoShapeParameters, InvalidParameterSpecification
from .ops.interp import morph_templates, morph_templates_np
from .utils import arrays_to_grid, inherit_docstring_from

__all__ = ['Morpher', 'GridInterpolator', 'MORPHERS']


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


MORPHERS = {x.__name__: x for x in [GridInterpolator]}
