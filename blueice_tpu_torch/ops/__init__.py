from .hist import Hist
from .interp import (morph_weights, morph_templates, morph_templates_np,
                     interp_at_points, interp_at_points_np, piecewise_lookup)
from .poisson import (binned_poisson_logl, binned_poisson_logl_constant,
                      extended_logl)
from .sampling import sample_from_template, poisson_counts
