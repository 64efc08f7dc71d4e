"""Exception hierarchy of blueice_tpu_torch (the same classes as
``blueice_tpu.exceptions``, so code catching them reads alike in both packages).

Mirrors the reference taxonomy (reference: blueice/exceptions.py:1-32), including the
historical misspelling ``NoOpimizationNecessary`` so downstream code written against
the reference keeps working unchanged.
"""

__all__ = [
    'BlueIceException', 'NoOpimizationNecessary', 'OptimizationFailed',
    'NotPreparedException', 'NoShapeParameters', 'InvalidParameter',
    'InvalidParameterSpecification', 'PDFNotComputedException',
]


class BlueIceException(Exception):
    """Root of all blueice_tpu_torch exceptions."""


class NoOpimizationNecessary(BlueIceException):
    """All parameters were fixed: there is nothing to optimize."""


class OptimizationFailed(BlueIceException):
    """The minimizer (and its fallback) failed to converge."""


class NotPreparedException(BlueIceException):
    """prepare() or set_data() must be called before this operation."""


class NoShapeParameters(BlueIceException):
    """A morpher was constructed without any shape parameters."""


class InvalidParameter(BlueIceException):
    """A particular parameter to the likelihood is not present."""


class InvalidParameterSpecification(BlueIceException):
    """An add_x_parameter method was called wrongly."""


class PDFNotComputedException(BlueIceException):
    """Attempt to use a PDF template that has not been computed yet."""
